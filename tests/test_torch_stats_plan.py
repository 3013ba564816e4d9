"""The stats kernel's launch plan (``ops/stats_kernels.plan_binned`` /
``plan_joint``) and its parameter structs, on the CPU.

The kernel itself runs only on the card (``chip_smoke.py`` phase 3c holds
it against its plain version); what the CPU can hold is the plan it is
launched with and the layout of the structs ctypes passes it: the header
``csrc/stats_hist_params.h`` is compiled with g++ and every field's offset
and size compared with the ctypes mirrors.
"""
import ctypes
import re
import subprocess

import pytest
import torch

from peleanalysis_tpu_torch.ops import cuda_build
from peleanalysis_tpu_torch.ops import stats_kernels as sk

# the H100's opt-in shared memory a block, and its SMs
MAX_SMEM = 232448
SMS = 132
PROD_CELLS = 2 * 128 ** 3 + 248 ** 3

# chip_smoke.py phase 3c's cases (1 M and 19.4 M flat cells), and the
# tools' level shapes: the repo and production cases' levels and a sparse
# cluster substate (64 x 64 x 832)
SIZES = [1 << 20, PROD_CELLS, 64 ** 3, 120 ** 3, 128 ** 3, 248 ** 3,
         64 * 64 * 832]
BINNED = [(64, 1, False), (64, 2, False), (64, 2, True), (16384, 2, True),
          (4096, 2, True), (64, 32, True)]
JOINT = [(64, 1), (64, 3), (256, 1), (256, 3)]
DTYPES = [torch.float32, torch.float64]


def _vec(dtype, aligned=True):
    return (2 if dtype == torch.float64 else 4) if aligned else 1


def _check_common(plan, n):
    assert plan.variant in sk.VARIANTS
    assert plan.threads in (512, 1024)
    assert plan.smem <= MAX_SMEM
    # the blocks an SM the plan counts on fit its shared memory and threads
    assert plan.blocks_per_sm * (plan.smem + sk.BLOCK_RESERVED) \
        <= sk.SM_SHARED
    assert plan.blocks_per_sm * plan.threads <= 2048
    assert plan.chunk % 4 == 0
    assert plan.nblocks * plan.chunk >= n
    assert (plan.nblocks - 1) * plan.chunk < n  # no wholly idle block
    assert plan.chunk <= sk.MAX_BLOCK_CELLS     # a block's cells < 2^24
    assert plan.nparts == (1 if plan.variant == "device" else plan.nblocks)
    assert 0 <= plan.mm_off <= plan.cnt_off <= plan.scratch_bytes
    assert plan.mm_off % 16 == 0 and plan.cnt_off % 16 == 0
    if plan.variant == "device":
        assert plan.smem == 0 and plan.threads == 512


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("nbins,ncomp,minmax", BINNED)
@pytest.mark.parametrize("n", SIZES)
def test_binned_plan(n, nbins, ncomp, minmax, dtype):
    es = 8 if dtype == torch.float64 else 4
    plan = sk.plan_binned(n, ncomp, nbins, minmax, False, dtype,
                          _vec(dtype), SMS, MAX_SMEM)
    _check_common(plan, n)
    slots = 2 * ncomp
    nmm = ncomp if minmax else 0
    copy = sk._copy_bytes(nbins, slots, nmm, True, es)
    if plan.variant == "shared":
        assert 1 <= plan.ncopies <= plan.threads // 32
        assert plan.smem == plan.ncopies * copy + 8 * nbins * slots
        if dtype == torch.float32:
            # the stated bound: at most BINNED_ADDS rounded float32 adds
            # into a slot between two folds into float64
            assert plan.slot_adds <= sk.BINNED_ADDS
            assert plan.round_cells % (plan.threads * plan.vec) == 0
        # partials: float64 sums, keys, counts
        assert plan.mm_off >= plan.nparts * nbins * slots * 8
        assert plan.scratch_bytes >= plan.cnt_off + plan.nparts * nbins * 4
    else:
        # one float64 accumulator: sums and counts in planes, keys
        assert plan.mm_off >= (slots + 2) * nbins * 8
        assert plan.scratch_bytes >= plan.mm_off + 2 * nbins * nmm * es


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("nbins,npairs", JOINT)
@pytest.mark.parametrize("n", SIZES)
def test_joint_plan(n, nbins, npairs, dtype):
    es = 8 if dtype == torch.float64 else 4
    plan = sk.plan_joint(n, npairs, nbins, False, dtype, _vec(dtype), SMS,
                         MAX_SMEM)
    _check_common(plan, n)
    total = npairs * nbins * nbins
    if plan.variant == "shared":
        assert plan.smem == sk._copy_bytes(total, 2, 0, True, es)
        # one rounded add of the state's type into a slot per run of a
        # block's cells at most
        assert plan.slot_adds == plan.chunk
        assert plan.mm_off >= plan.nparts * total * 2 * es
        assert plan.scratch_bytes >= plan.cnt_off + plan.nparts * total * 4
    else:
        # float64 planes: bx1, bx2, counts, pad
        assert plan.scratch_bytes >= 4 * total * 8


def test_plan_variants_of_the_smoke_cases():
    """The variants phase 3c exercises: shared memory for 64 bins (float32
    binned moments four blocks an SM), device memory for 16384 binned
    bins, 256 joint bins and float64 joint pdfs of 3 pairs."""
    f32, f64 = torch.float32, torch.float64

    def b(nbins, dt):
        return sk.plan_binned(PROD_CELLS, 2, nbins, True, False, dt,
                              _vec(dt), SMS, MAX_SMEM)

    def j(nbins, pairs, dt):
        return sk.plan_joint(PROD_CELLS, pairs, nbins, False, dt, _vec(dt),
                             SMS, MAX_SMEM)
    assert b(64, f32).variant == b(64, f64).variant == "shared"
    assert b(64, f32).blocks_per_sm == 4 and b(64, f32).ncopies == 16
    assert b(16384, f32).variant == b(16384, f64).variant == "device"
    assert j(64, 1, f32).variant == j(64, 3, f32).variant == "shared"
    assert j(64, 3, f32).threads == 1024
    assert j(256, 1, f32).variant == j(64, 3, f64).variant == "device"


def test_plan_weights_and_unaligned():
    """Per-cell weights add the weight-sum slot (and its pad) and drop the
    counts; an unaligned field is planned one cell a thread at a time."""
    w = sk.plan_binned(1 << 20, 1, 64, False, True, torch.float32, 4, SMS,
                       MAX_SMEM)
    assert w.cnt_off == w.scratch_bytes or w.scratch_bytes - w.cnt_off < 16
    assert w.smem == w.ncopies * sk._copy_bytes(64, 4, 0, False, 4) \
        + 8 * 64 * 4
    u = sk.plan_binned(1 << 20, 1, 64, False, False, torch.float32, 1, SMS,
                       MAX_SMEM)
    assert u.vec == 1 and u.slot_adds <= sk.BINNED_ADDS
    jw = sk.plan_joint(1 << 20, 2, 64, True, torch.float64, 2, SMS, MAX_SMEM)
    assert jw.smem <= MAX_SMEM


@pytest.mark.parametrize("dtype,ptrs,mask,expect", [
    (torch.float32, [0, 16, 4096], 4, 4),
    (torch.float32, [0, 20], 4, 1),          # a field off 16 bytes
    (torch.float32, [0, 16], 6, 1),          # the mask off 4 bytes
    (torch.float64, [32, 48], 2, 2),
    (torch.float64, [32, 40], 2, 1),
    (torch.float64, [32, 48], 3, 1),
])
def test_vec_width(dtype, ptrs, mask, expect):
    assert sk.vec_width(dtype, ptrs, mask) == expect


def _layout_program(tmp_path) -> dict:
    """sizeof and every field's offset of the three structs, as g++ lays
    out csrc/stats_hist_params.h."""
    lines = []
    for struct, cls in (("StatsPlan", sk._StatsPlan),
                        ("BinnedParams", sk._BinnedParams),
                        ("JointParams", sk._JointParams)):
        lines.append(f'printf("{struct} sizeof %zu\\n", sizeof({struct}));')
        for name, _ in cls._fields_:
            lines.append(f'printf("{struct} {name} %zu\\n", '
                         f'offsetof({struct}, {name}));')
    src = tmp_path / "layout.cpp"
    src.write_text('#include <cstddef>\n#include <cstdio>\n'
                   f'#include "{cuda_build.CSRC / "stats_hist_params.h"}"\n'
                   'int main() {\n' + "\n".join(lines) + "\nreturn 0;\n}\n")
    exe = tmp_path / "layout"
    subprocess.run(["g++", "-std=c++17", "-o", str(exe), str(src)],
                   check=True, capture_output=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True).stdout
    return {tuple(ln.split()[:2]): int(ln.split()[2])
            for ln in out.splitlines()}


def test_struct_layout_matches_ctypes(tmp_path):
    got = _layout_program(tmp_path)
    for struct, cls in (("StatsPlan", sk._StatsPlan),
                        ("BinnedParams", sk._BinnedParams),
                        ("JointParams", sk._JointParams)):
        assert got[(struct, "sizeof")] == ctypes.sizeof(cls), struct
        for name, _ in cls._fields_:
            assert got[(struct, name)] == getattr(cls, name).offset, \
                (struct, name)
    # every field of the C structs has its ctypes mirror, in order
    header = (cuda_build.CSRC / "stats_hist_params.h").read_text()
    for struct, cls in (("StatsPlan", sk._StatsPlan),
                        ("BinnedParams", sk._BinnedParams),
                        ("JointParams", sk._JointParams)):
        body = re.search(r"struct %s \{(.*?)\};" % struct, header, re.S)
        names = []
        for decl in re.sub(r"//[^\n]*", "", body.group(1)).split(";"):
            parts = decl.split(",")
            if not parts[0].strip():
                continue
            names += [re.sub(r"\[.*", "", part.split()[-1])
                      for part in parts]
        assert names == [f for f, _ in cls._fields_], struct


def test_struct_limits_match_header():
    header = (cuda_build.CSRC / "stats_hist_params.h").read_text()
    for name, val in (("MAXC", sk.MAXC), ("MAXV", sk.MAXV),
                      ("MAXP", sk.MAXP)):
        assert re.search(rf"#define STATS_{name} (\d+)", header).group(1) \
            == str(val)


def test_header_edit_rebuilds():
    """The build's name hashes the headers beside the sources too."""
    assert "stats_hist_params.h" in {p.name for p in
                                     cuda_build.CSRC.glob("*.h")}
    path = cuda_build.library_path("stats_hist")
    assert path.name.startswith("libstats_hist_")
