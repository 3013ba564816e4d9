"""The migrating march of partStream: particles move to the shard that owns
their block after every RK4 step (the Redistribute analog).

Counterpart of ``peleanalysis_tpu/parallel/particles.py``, itself the
multi-chip path of the reference's StreamPC (Src/StreamPC.cpp:86-141,
``Redistribute()`` after every step).  The level's grown velocity field is
filled as the JAX package fills it, then cut into blocks over a 1-D, 2-D or
3-D block grid of ``ceil(S/n)`` grown cells a block, each with a halo of
one RK4 step's reach (``ceil(h/dx) + 2`` cells), on its shard's device.
The blocks are cut to the global grown box, not edge-padded beyond it as
the JAX ``_build_slabs`` pads them: the march then bounds a line by the
grown box itself, so a block's lines compute exactly what they compute in
the resident march.

Each step launches the march (``stream/march_kernels.py``
``march`` over a window: the CUDA kernel on the card) once a block with
``n_steps=1`` over the block's live lines, in the grown box's coordinates.
The movers' position, direction and id then go to their owner, routed
dimension by dimension as the JAX mesh axes route them, one ``.to(device)``
a hop (a step crosses at most one block a dimension: the halo is one
step's reach and a block's core is wider).  A frozen line stays where it
froze.  Each step logs the moved lines' positions, and the paths come back
in seed order, ``[nseed, n_steps + 1, 3]``: the resident march's, bit for
bit.

The slot accounting is the JAX package's: a block holds at most
``capacity`` lines (default twice the largest initial load, at least 8),
frozen lines included, and sends at most ``send_capacity`` a direction a
dimension (default half that, at least 8); a run the JAX package refuses
for capacity is refused here with the same error.  3-D only, as in JAX.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..amr.dense import DenseAmrState
from ..ops.dense_fill import fill_dense_arrays
from ..stream.march_kernels import march, prepare_field
from ..stream.trace import (_sample_fields, assign_seeds_to_levels,
                            push_nodes_inside)
from .mesh import Mesh

AXIS = "parts"


def migrate_march(vec: torch.Tensor, plo_g, dx, h_phys: float,
                  seeds: np.ndarray, n_steps: int, dirs: np.ndarray,
                  mesh: Mesh, capacity: Optional[int] = None,
                  send_capacity: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """March ``seeds`` (each with its +-1 ``dirs``) ``n_steps`` RK4 steps
    through the grown field ``vec`` ``[3, SX, SY, SZ]`` (on any device)
    whose lower corner is at ``plo_g``, block-sharded over ``mesh`` (its
    first k axes cut the first k dims), the lines migrating after every
    step.  Returns (float64 paths ``[nseed, n_steps+1, 3]``, initial load of
    each block).  Raises on send or slot capacity overflow."""
    vec = torch.as_tensor(vec)
    nds = tuple(int(n) for n in mesh.shape)
    k = len(nds)
    ndev = mesh.size
    shape = tuple(int(s) for s in vec.shape[1:])
    dx = np.asarray(dx, dtype=np.float64)
    plo_g = np.asarray(plo_g, dtype=np.float64)
    cores, halos = [], []
    for d in range(k):
        core_d = -(-shape[d] // nds[d])
        halo_d = int(np.ceil(h_phys / float(dx[d]))) + 2
        if nds[d] > 1 and core_d <= halo_d:
            raise ValueError(
                f"block core {core_d} cells <= halo {halo_d} along dim {d}:"
                f" fewer devices needed for extent {shape[d]}")
        cores.append(core_d)
        halos.append(halo_d)

    seeds = np.asarray(seeds, dtype=np.float64)
    dirs = np.asarray(dirs, dtype=np.float64)
    nseed = len(seeds)
    own_nd = [np.clip(((seeds[:, d] - plo_g[d]) / dx[d]
                       // cores[d]).astype(np.int64), 0, nds[d] - 1)
              for d in range(k)]
    own = (np.ravel_multi_index(own_nd, nds) if nseed
           else np.zeros(0, np.int64))
    counts = np.bincount(own, minlength=ndev)
    cap = capacity or max(8, int(2 * counts.max(initial=0)))
    if counts.max(initial=0) > cap:
        raise ValueError(f"capacity {cap} < max initial load {counts.max()}")
    scap = send_capacity or max(8, cap // 2)

    fields, origins = [], []
    for s in range(ndev):
        idx = mesh.index(s)
        sl, org = [], []
        for d in range(3):
            if d < k:
                lo = max(0, idx[d] * cores[d] - halos[d])
                hi = min(shape[d], (idx[d] + 1) * cores[d] + halos[d])
            else:
                lo, hi = 0, shape[d]
            sl.append(slice(lo, hi))
            org.append(lo)
        fields.append(prepare_field(
            vec[(slice(None),) + tuple(sl)].to(mesh.devices[s])))
        origins.append(tuple(org))

    # each block's live lines [n, 5]: position, direction, seed id
    lines = []
    for s in range(ndev):
        sel = np.nonzero(own == s)[0]
        rows = np.concatenate([seeds[sel], dirs[sel, None],
                               sel[:, None].astype(np.float64)], axis=1)
        lines.append(torch.from_numpy(rows).to(mesh.devices[s]))
    used = counts.astype(np.int64)            # slots held, frozen included
    over = False
    logs = []                                 # (step, ids, positions)
    plo_t = [float(v) for v in plo_g]
    for step in range(n_steps):
        for s in range(ndev):
            live = lines[s]
            if live.shape[0] == 0:
                continue
            pos = live[:, :3].contiguous()
            pos2, alive = march(fields[s], plo_t, dx, h_phys, pos, 1,
                                live[:, 3].contiguous(), origins[s], shape)
            logs.append((step, live[:, 4], pos2[1]))
            # a frozen line keeps its slot and leaves the live set
            lines[s] = torch.cat([pos2[1][alive], live[alive, 3:]], dim=1)
        for d in range(k):
            if nds[d] == 1:
                continue
            sends = []
            for s in range(ndev):
                me = mesh.index(s)[d]
                sx = (lines[s][:, d] - plo_t[d]) / float(dx[d])
                to = torch.clamp(torch.floor(sx / cores[d]), 0, nds[d] - 1)
                right, left = to > me, to < me
                n_r, n_l = int(right.sum()), int(left.sum())
                over |= n_r > scap or n_l > scap
                used[s] -= n_r + n_l
                sends.append((lines[s][right], lines[s][left]))
                lines[s] = lines[s][~(right | left)]
            for s in range(ndev):
                idx = list(mesh.index(s))
                got = []
                for step_d, which in ((-1, 0), (1, 1)):
                    nb = idx[d] + step_d
                    if 0 <= nb < nds[d]:
                        src = mesh.shard(idx[:d] + [nb] + idx[d + 1:])
                        got.append(sends[src][which].to(mesh.devices[s]))
                n_in = sum(g.shape[0] for g in got)
                over |= n_in > cap - used[s]
                used[s] += n_in
                lines[s] = torch.cat([lines[s]] + got)
    if over:
        raise RuntimeError(
            "particle migration overflow: raise capacity=/send_capacity=")
    out = np.zeros((nseed, n_steps + 1, 3))
    out[:, 0] = seeds
    last = np.zeros(nseed, np.int64)
    for step, ids, pos in logs:
        i = ids.cpu().numpy().astype(np.int64)
        out[i, step + 1] = pos.cpu().numpy()
        last[i] = step + 1
    # a frozen line stays at its last position
    for step in range(n_steps):
        stale = last < step + 1
        out[stale, step + 1] = out[stale, step]
    return out, counts


def trace_streamlines_migrating(
        dstate: DenseAmrState, seeds: np.ndarray, n_rk_steps: int,
        h_rk: float, mesh: Mesh, sample_names: Sequence[str] = (), bc=None,
        capacity: Optional[int] = None) -> np.ndarray:
    """partStream over several shards: each level's grown velocity field
    filled on the state's device and cut into ``mesh``'s blocks, the +-
    march run as one doubled-seed migrating cloud, paths reassembled in
    seed order.  Same output layout as ``stream.trace.trace_streamlines``
    (``[nseed, 2*nRKh+1, 3+nf]``, the seed at station nRKh), and the same
    lines, bit for bit."""
    meta = dstate.meta
    n_half = (n_rk_steps - 1) // 2
    fin = meta.n_levels - 1
    h_phys = h_rk * meta.geoms[fin].dx[0]
    seeds = push_nodes_inside(np.asarray(seeds, np.float64), meta.geoms[0])
    owner = assign_seeds_to_levels(dstate, seeds)
    vec_names = ["x_velocity", "y_velocity", "z_velocity"]
    if "z_velocity" not in dstate.names:
        raise ValueError("the migrating march is 3-D only (2-D plotfiles "
                         "fit one device; use the resident engine)")
    comps = [dstate.comp(n) for n in vec_names + list(sample_names)]
    masks = [dstate.in_level_mask(l) for l in range(meta.n_levels)]
    all_data = [d[comps] for d in dstate.data]
    nf = len(sample_names)
    out = np.zeros((len(seeds), 2 * n_half + 1, 3 + nf))
    for lev in range(meta.n_levels):
        sel = np.nonzero(owner == lev)[0]
        if len(sel) == 0:
            continue
        geom = meta.geoms[lev]
        dx = np.array(geom.dx)
        ngrow = int(np.ceil(h_phys * n_half / dx.min())) + 2
        gbox = dstate.lmeta[lev].bbox.grow(ngrow)
        plo_g = (np.array(geom.prob_lo)
                 + (np.array(gbox.lo) - np.array(geom.domain.lo)) * dx)
        grown = fill_dense_arrays(meta, dstate.lmeta, all_data, masks, lev,
                                  ngrow, bc, "linear")
        ns = len(sel)
        seeds2 = np.concatenate([seeds[sel], seeds[sel]])
        dirs = np.concatenate([np.ones(ns), -np.ones(ns)])
        pos2, _ = migrate_march(grown[:3], plo_g, dx, h_phys, seeds2,
                                n_half, dirs, mesh, capacity=capacity)
        path = np.concatenate([pos2[ns:, ::-1][:, :-1], pos2[:ns]], axis=1)
        if nf:
            vals = _sample_fields(grown[3:], plo_g, dx,
                                  torch.from_numpy(path).to(dstate.device))
            path = np.concatenate([path, vals.cpu().numpy()], axis=-1)
        out[sel] = path
    return out
