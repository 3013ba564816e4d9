"""The inputs: the same seed gives the same bytes, another seed another
field, and the program reads back what was generated."""
from __future__ import annotations

import hashlib
import os

import numpy as np
import pytest
import torch

from conftest import SEED, tiny_cell
from portbench import gen
from portbench.amr import box_shape, hierarchy


def _digest(path: str) -> str:
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(path)):
        for f in sorted(files):
            with open(os.path.join(d, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()


@pytest.mark.parametrize("workload", ["flame-series", "flame-explore"])
def test_inputs_deterministic_per_seed(tmp_path, workload):
    cfg = tiny_cell(workload).config
    a, b, c = (str(tmp_path / x) for x in "abc")
    gen.write_inputs(cfg, SEED, [a], "cpu")
    gen.write_inputs(cfg, SEED, [b], "cpu")
    gen.write_inputs(cfg, SEED + 1, [c], "cpu")
    assert _digest(a) == _digest(b)
    assert _digest(a) != _digest(c)


@pytest.mark.parametrize("workload", ["flame-series", "flame-explore"])
def test_program_reads_generated_fields(tmp_path, workload):
    from peleanalysis_tpu_torch.amr.hierarchy import load_plotfile_fabs
    cfg = tiny_cell(workload).config
    p = str(tmp_path / "plt")
    h = gen.write_inputs(cfg, 123, [p], "cpu")
    meta, names, fabs = load_plotfile_fabs(p)
    assert names == cfg["components"]
    for lev in range(h.n_levels):
        f = gen.level_fields(cfg, h, 123, 0, lev, "cpu")
        lo = h.bboxes[lev][0]
        for b, fab in zip(h.boxes[lev], fabs[lev]):
            sl = tuple(slice(b[0][d] - lo[d], b[1][d] - lo[d] + 1)
                       for d in range(3))
            want = np.stack([f[n][sl].numpy() for n in names])
            assert fab.shape == (len(names),) + box_shape(b)
            np.testing.assert_array_equal(fab, want)


def _iso_values(cell) -> list:
    """Every iso value a cell's traffic asks for: fixed ones, and the ends
    of a drawn range."""
    tr, vals = cell.traffic, []
    for ch in tr.get("checks", []):
        if ch["type"] == "mef":
            vals.append(float(ch["iso_val"]))
    for k in tr.get("requests", []):
        for p in k.get("params", {}).values():
            if "uniform" in p and k["argv"][0] == "isosurface":
                vals += [float(x) for x in p["uniform"]]
    return vals


@pytest.mark.parametrize("size", ["tiny", "committed"])
def test_ghost_fill_reaches_no_output(size):
    """The reference's premise: no cell whose value could place a surface
    node lies in a coarser level's valid cells or within three cells of
    the finest level's coarse-fine faces, so neither the surfaces nor the
    curvatures sampled on them (stencils of two cells) read a ghost cell
    filled from a coarser level; the statistics read valid cells only.
    Checked on the fields themselves, at both sizes."""
    from portbench.spec import load_config
    cells = [tiny_cell(w) for w in ("flame-series", "flame-explore")]
    isos = sorted(v for c in cells for v in _iso_values(c))
    cfg = cells[0].config if size == "tiny" else load_config("flamesheet3d")
    h = hierarchy(cfg)
    fin = h.n_levels - 1
    for seed in (SEED, 7):
        for lev in range(h.n_levels):
            t = gen.level_fields(cfg, h, seed, 0, lev, "cpu")["temp"]
            if lev < fin:
                v = t[torch.from_numpy(h.valid(lev))]
            else:
                box, dom = h.bboxes[fin], h.domains[fin]
                assert box[0][2] > dom[0][2] and box[1][2] < dom[1][2]
                assert [box[0][d] for d in (0, 1)] == [0, 0]
                assert [box[1][d] for d in (0, 1)] == [dom[1][0], dom[1][1]]
                # fresh gas below, burnt gas above: each face's band of
                # three cells wholly on its side of every iso value
                assert bool((t[:, :, :3] < isos[0]).all())
                assert bool((t[:, :, -3:] > isos[-1]).all())
                continue
            assert not bool(((v > isos[0]) & (v < isos[-1])).any()), lev


def test_every_seed_the_same_surface():
    """Seeds move the front across the periodic axes: the same surface,
    of the same area to the grid's rounding."""
    from portbench.spec import load_kind
    from portbench.reference.flame import isosurface
    cfg = tiny_cell("flame-series").config
    h = hierarchy(cfg)
    State = load_kind(cfg["kind"]).State
    areas = [isosurface(State(cfg, h, s, 0, "cpu", torch.float64), "temp",
                        1000.0, [])["area"] for s in (SEED, 1, 2)]
    assert max(areas) / min(areas) < 1.02, areas


def test_hierarchy_patches_snap_to_blocks():
    """Patches are physical boxes widened to whole blocks; cells between
    two patches of a level belong to none and are not valid."""
    cfg = {"amr.n_cell": [8, 8, 8], "amr.ref_ratio": 2,
           "amr.blocking_factor": 4, "amr.max_grid_size": 4,
           "geometry.prob_lo": [0.0, 0.0, 0.0],
           "geometry.prob_hi": [1.0, 1.0, 1.0],
           "refined": [[[[0.05, 0.05, 0.05], [0.3, 0.3, 0.3]],
                        [[0.8, 0.8, 0.8], [0.9, 0.9, 0.9]]]]}
    h = hierarchy(cfg)
    assert h.bboxes[1] == ((0, 0, 0), (15, 15, 15))
    assert all(box_shape(b) == (4, 4, 4) for b in h.boxes[1])
    assert len(h.boxes[1]) == 8 + 1
    own = h.owned(1)
    assert own.sum() == 9 * 64 and not own[8:12, 8:12, 8:12].any()
    assert h.valid(0).sum() == 8 ** 3 - own.sum() // 8
    assert h.cells() == 8 ** 3 + 9 * 64


def test_committed_sizes():
    from portbench.spec import load_config
    cfg = load_config("flamesheet3d")
    h = hierarchy(cfg)
    assert h.cells() == 3_170_304
    assert len(cfg["components"]) == 32
    assert len(cfg["species"]) == 21
    assert [f"rho.Y({s})" for s in cfg["species"]] == cfg["components"][4:25]
    assert h.dx(h.n_levels - 1) == pytest.approx(0.016 / 192)


def _whole_level_writer(path, cfg, seed):
    """The writer the streamed one replaced, kept as its reference: every
    component of a level evaluated at once, its boxes in one host array,
    each Cell_D file written in one pass."""
    from portbench.amr import FAB_F64, FABS_PER_FILE, box_str
    from portbench.spec import load_kind
    kind, h, names = load_kind(cfg["kind"]), hierarchy(cfg), \
        cfg["components"]
    nc = len(names)
    payloads = []
    for lev in range(h.n_levels):
        f = kind.level_fields(cfg, h, seed, 0, lev, "cpu")
        lo = h.bboxes[lev][0]
        d = torch.stack([f.pop(n) for n in names])
        parts = []
        for b in h.boxes[lev]:
            sl = tuple(slice(b[0][a] - lo[a], b[1][a] - lo[a] + 1)
                       for a in range(3))
            parts.append(d[(slice(None),) + sl].permute(0, 3, 2, 1)
                         .reshape(-1))
        payloads.append(torch.cat(parts).cpu().numpy())
    os.makedirs(path)
    with open(os.path.join(path, "Header"), "w") as f:
        f.write("HyperCLaw-V1.1\n" f"{nc}\n")
        f.write("".join(nm + "\n" for nm in names))
        f.write(f"3\n{0.0!r}\n{h.n_levels - 1}\n")
        f.write("".join(f"{x!r} " for x in h.prob_lo) + "\n")
        f.write("".join(f"{x!r} " for x in h.prob_hi()) + "\n")
        f.write(" ".join(str(h.ref_ratio) for _ in range(h.n_levels - 1))
                + " \n")
        f.write(" ".join(box_str(d) for d in h.domains) + " \n")
        f.write(" ".join("0" for _ in range(h.n_levels)) + " \n")
        for lev in range(h.n_levels):
            dx = h.dx(lev)
            f.write(f"{dx!r} {dx!r} {dx!r} \n")
        f.write("0\n0\n")
        for lev, bs in enumerate(h.boxes):
            dx = h.dx(lev)
            f.write(f"{lev} {len(bs)} {0.0!r}\n0\n")
            for b in bs:
                for d in range(3):
                    lo = h.prob_lo[d]
                    f.write(f"{lo + b[0][d] * dx!r} "
                            f"{lo + (b[1][d] + 1) * dx!r}\n")
            f.write(f"Level_{lev}/Cell\n")
    for lev, bs in enumerate(h.boxes):
        dirname = os.path.join(path, f"Level_{lev}")
        os.makedirs(dirname)
        flat = payloads[lev]
        entries, mins, maxs, at = [], [], [], 0
        for first in range(0, len(bs), FABS_PER_FILE):
            fname = f"Cell_D_{first // FABS_PER_FILE:05d}"
            with open(os.path.join(dirname, fname), "wb") as f:
                for b in bs[first: first + FABS_PER_FILE]:
                    n = nc * int(np.prod(box_shape(b)))
                    block = flat[at: at + n]
                    entries.append((fname, f.tell()))
                    f.write(f"{FAB_F64}{box_str(b)} {nc}\n".encode("ascii"))
                    f.write(memoryview(block))
                    mins.append(block.reshape(nc, -1).min(axis=1))
                    maxs.append(block.reshape(nc, -1).max(axis=1))
                    at += n
        with open(os.path.join(dirname, "Cell_H"), "w") as f:
            f.write(f"1\n1\n{nc}\n0\n({len(bs)} 0\n")
            f.write("".join(box_str(b) + "\n" for b in bs))
            f.write(f")\n{len(bs)}\n")
            f.write("".join(f"FabOnDisk: {fn} {off}\n"
                            for fn, off in entries))
            for table in (mins, maxs):
                f.write(f"\n{len(bs)},{nc}\n")
                f.write("".join(",".join(repr(float(v)) for v in row)
                                + ",\n" for row in table))


def _file_digests(path: str) -> dict:
    out = {}
    for d, _, files in os.walk(path):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, path)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def _patches_cfg() -> dict:
    """The tiny flame with two patches a level and boxes of 4 cells a
    side: a level of more boxes than one Cell_D file holds."""
    cfg = dict(tiny_cell("flame-series").config)
    cfg.update({"amr.max_grid_size": 4, "refined": [
        [[[0.0, 0.0, 0.008], [0.016, 0.016, 0.024]],
         [[0.0, 0.0, 0.002], [0.004, 0.004, 0.006]]],
        [[[0.0, 0.0, 0.010], [0.016, 0.016, 0.022]],
         [[0.010, 0.010, 0.024], [0.014, 0.014, 0.028]]]]})
    return cfg


@pytest.mark.parametrize("size,piece", [
    ("tiny", None), ("committed", None), ("committed", 20_000_000),
    ("patches", None), ("patches", 1), ("patches", 3 * 8 * 32 * 32 * 40)])
def test_streamed_writer_writes_the_whole_level_writers_bytes(
        tmp_path, monkeypatch, size, piece):
    """Every file byte-equal to the reference writer's, in one piece a
    level or forced into many (one component a piece; three)."""
    from portbench.spec import load_config
    cfg = {"tiny": lambda: tiny_cell("flame-series").config,
           "committed": lambda: load_config("flamesheet3d"),
           "patches": _patches_cfg}[size]()
    h = hierarchy(cfg)
    nc = len(cfg["components"])
    if piece is not None:
        monkeypatch.setattr(gen, "PIECE_BYTES", piece)
    plans = [gen.pieces(h, lev, nc) for lev in range(h.n_levels)]
    if piece is None:
        assert all(p == [(0, nc)] for p in plans)
    else:
        assert max(len(p) for p in plans) > 1
    if size == "patches":
        assert max(len(bs) for bs in h.boxes) > 64
    gen.write_inputs(cfg, SEED, [str(tmp_path / "s")], "cpu")
    got = _file_digests(str(tmp_path / "s"))
    _whole_level_writer(str(tmp_path / "w"), cfg, SEED)
    assert got == _file_digests(str(tmp_path / "w"))
    sizes = sum(os.path.getsize(tmp_path / "s" / f) for f in got
                if "Cell_D" in f)
    assert gen.input_bytes(cfg, 1) == sizes


def test_a_piece_holds_one_component_at_the_least(monkeypatch):
    cfg = tiny_cell("flame-series").config
    h = hierarchy(cfg)
    monkeypatch.setattr(gen, "PIECE_BYTES", 1)
    assert gen.pieces(h, 2, 5) == [(c, c + 1) for c in range(5)]
    cells = int(np.prod(box_shape(h.bboxes[2])))
    monkeypatch.setattr(gen, "PIECE_BYTES", 16 * cells + 8)
    assert gen.pieces(h, 2, 5) == [(0, 2), (2, 4), (4, 5)]
