"""Streamline integration: seeds, the per-level grown fill, the RK4 march
and the sampling of fields along the lines (dense path).

Counterpart of ``peleanalysis_tpu/stream/trace.py``, which replaces the
reference's per-box Fortran stack (Src/stream.cpp:888-934 + stream_nd.f90):

  * seeds are assigned to the finest level containing them, with finer-box
    exclusion (setInsideNodes, stream.cpp:140-215);
  * per level, ONE dense grown array with ghost radius
    nGrow = ceil(h * nRKh / dx) + 2 keeps every path inside the sampled
    region (the grow-box strategy, stream.cpp:700-720);
  * tracing "up the gradient" takes the centred gradient of a scalar on the
    grown array (the ``grad_mag`` kernel), or uses the velocity components;
  * the +- march of a level's seeds is ONE call of ``march_kernels.march``
    over the doubled seeds: the CUDA kernel on the card;
  * each level's lines (and sampled fields) come back to the host in one
    copy, exact or, with ``fetch_compress``, as the JAX package's lossy
    packing (int16 station deltas, uint16 per-line field ranges); with
    ``defer=True`` every level's payload stays on the device until
    ``DeferredLines.finish`` copies them all, and any extra device
    tensors, in one copy.

Paths are ``[nseed, 2*nRKh+1, 3+nfields]`` with the seed at station nRKh.
Sparse refinement: ``trace_streamlines_sparse`` marches each finest-level
cluster's seeds on its own substate (amr/cluster.py) and the other seeds on
the coarse levels.  Not ported: march chunking, and the JAX sparse path's
canonical frames and seed padding.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..amr.cluster import cluster_substates, coarse_only_state
from ..amr.dense import DenseAmrState
from ..ops.dense_fill import fill_dense_arrays
from ..ops.grad_kernels import grad_mag
from .march_kernels import march, prepare_field

# marchEngine names -> the device type the state must be on (None: any).
# Whatever the name, the march runs the kernel on a CUDA state and its plain
# version on a CPU state; the JAX package's "pallas" and "xla" compute the
# same march and are accepted so its command lines run unchanged
ENGINES = {"auto": None, "pallas": None, "xla": None,
           "cuda": "cuda", "torch": "cpu"}


def assign_seeds_to_levels(dstate: DenseAmrState,
                           seeds: np.ndarray) -> np.ndarray:
    """Owner level per seed: finest level whose union contains the seed
    (setInsideNodes with fine-box exclusion, stream.cpp:140-215)."""
    meta = dstate.meta
    owner = np.zeros(len(seeds), dtype=np.int32)
    for lev in range(meta.n_levels):
        geom = meta.geoms[lev]
        bbox = dstate.lmeta[lev].bbox
        dx = np.array(geom.dx)
        idx = np.floor((seeds - np.array(geom.prob_lo)) / dx).astype(np.int64)
        idx += np.array(geom.domain.lo)
        loc = idx - np.array(bbox.lo)
        inside = np.all((loc >= 0) & (loc < np.array(bbox.shape)), axis=1)
        mask = dstate.in_level_mask_np(lev)
        li = np.clip(loc, 0, np.array(bbox.shape) - 1)
        inlev = mask[li[:, 0], li[:, 1], li[:, 2]] & inside
        owner[inlev] = lev
    return owner


def push_nodes_inside(seeds: np.ndarray, geom, eps_frac: float = 1.0e-4
                      ) -> np.ndarray:
    """Nudge seeds strictly inside the domain (push_nodes_inside,
    stream.cpp:122-138)."""
    lo = np.array(geom.prob_lo)
    hi = np.array(geom.prob_hi)
    eps = eps_frac * np.array(geom.dx)
    return np.clip(seeds, lo + eps, hi - eps)


def seed_rake(lo, hi, n: int) -> np.ndarray:
    """n seeds on the segment lo..hi (seedRake, stream.cpp:506-532)."""
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    t = np.linspace(0.0, 1.0, n)[:, None]
    return lo[None] + t * (hi - lo)[None]


def _sample_fields(fields: torch.Tensor, plo, dx,
                   pos: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of all comps at path points (interpstream analog,
    sampleStreamlines_nd.f90:11-41).  fields [nf, SX, SY, SZ], pos [..., 3]
    -> [..., nf]; plain torch gathers."""
    dt, dev = pos.dtype, pos.device
    plo_t = torch.tensor([float(v) for v in plo], dtype=dt, device=dev)
    dx_t = torch.tensor([float(v) for v in dx], dtype=dt, device=dev)
    hi = torch.tensor([s - 2 for s in fields.shape[1:]], dtype=dt, device=dev)
    xc = (pos - plo_t) / dx_t - 0.5
    b = torch.minimum(torch.clamp(torch.floor(xc), min=0), hi)
    t = torch.clamp(xc - b, 0.0, 1.0)
    bi = b.long()
    i, j, k = bi[..., 0], bi[..., 1], bi[..., 2]
    tx, ty, tz = t[..., 0:1], t[..., 1:2], t[..., 2:3]

    def g(oi, oj, ok):
        return torch.movedim(fields[:, i + oi, j + oj, k + ok], 0, -1)

    return ((1 - tx) * (1 - ty) * (1 - tz) * g(0, 0, 0)
            + tx * (1 - ty) * (1 - tz) * g(1, 0, 0)
            + (1 - tx) * ty * (1 - tz) * g(0, 1, 0)
            + tx * ty * (1 - tz) * g(1, 1, 0)
            + (1 - tx) * (1 - ty) * tz * g(0, 0, 1)
            + tx * (1 - ty) * tz * g(1, 0, 1)
            + (1 - tx) * ty * tz * g(0, 1, 1)
            + tx * ty * tz * g(1, 1, 1))


def _pack_compressed(path: torch.Tensor, vals: Optional[torch.Tensor],
                     h: float, n_half: int) -> torch.Tensor:
    """The lossy line payload of the JAX package's ``fetch_compress``
    (stream/trace.py:413-460) as one int16 vector: the seed station in
    float32, int16 station deltas in units of h/32000 (clamped to
    +-32767), and per line and comp the float32 (min, max) with uint16
    range-quantised samples."""
    d = path[:, 1:] - path[:, :-1]
    q = torch.clamp(torch.round(d * (32000.0 / h)), -32767.0, 32767.0)
    parts = [path[:, n_half].to(torch.float32).reshape(-1).view(torch.int16),
             q.to(torch.int16).reshape(-1)]
    if vals is not None:
        v32 = vals.to(torch.float32)                       # [ns, st, nf]
        vmin = v32.amin(dim=1)
        vmax = v32.amax(dim=1)
        rng = torch.clamp(vmax - vmin, min=1e-30)
        vq = torch.round((v32 - vmin[:, None]) / rng[:, None] * 65535.0)
        vq = vq.to(torch.int32)
        vq = torch.where(vq >= 32768, vq - 65536, vq).to(torch.int16)
        parts += [torch.stack([vmin, vmax], -1).reshape(-1).view(torch.int16),
                  vq.reshape(-1)]                   # uint16 bits in int16
    return torch.cat(parts)


def _decode_compressed(packed: np.ndarray, sel, out, n_half: int, nf: int,
                       h_phys: float) -> None:
    """Write one level's packed payload into out[sel] (the JAX package's
    ``_decode_level`` arithmetic)."""
    ns = len(sel)
    st = 2 * n_half + 1
    nq = ns * 2 * n_half * 3
    p = 0
    pc = packed[p: p + ns * 6].view(np.float32).reshape(ns, 3).astype(
        np.float64)
    p += ns * 6
    q = packed[p: p + nq].reshape(ns, 2 * n_half, 3)
    p += nq
    d = q.astype(np.float64) * (h_phys / 32000.0)
    # stations ..n_half-1 | n_half (exact seed) | n_half+1..
    fwd = pc[:, None] + np.cumsum(d[:, n_half:], axis=1)
    bwd = pc[:, None] - np.cumsum(d[:, :n_half][:, ::-1], axis=1)[:, ::-1]
    out[sel, :, :3] = np.concatenate([bwd, pc[:, None], fwd], axis=1)
    if nf:
        mm = packed[p: p + ns * nf * 4].view(np.float32).reshape(ns, nf, 2)
        p += ns * nf * 4
        vq = packed[p: p + ns * st * nf].view(np.uint16).reshape(ns, st, nf)
        rngv = np.maximum(mm[:, :, 1] - mm[:, :, 0], 1e-30)
        out[sel, :, 3:] = (mm[:, None, :, 0]
                           + vq.astype(np.float64) / 65535.0
                           * rngv[:, None])


def trace_streamlines(
    dstate: DenseAmrState,
    seeds: np.ndarray,
    n_rk_steps: int,
    h_rk: float,
    trace_field: Optional[str] = None,
    sample_names: Sequence[str] = (),
    bc=None,
    march_dtype: Optional[str] = None,
    march_engine: str = "auto",
    ngrow: Optional[int] = None,
    fetch_compress: Optional[bool] = None,
    defer: bool = False,
) -> np.ndarray:
    """Trace +-nRKh RK4 steps from each seed; returns float64
    ``[nseed, 2*nRKh+1, 3 + len(sample_names)]`` with the seed at station
    nRKh (nRKh = (nRKsteps-1)//2, the reference's convention).

    trace_field: scalar whose (normalised) gradient is followed; None
    follows (x,y,z)_velocity.  h_rk is in units of the finest dx
    (stream.cpp:700).  Positions, the march's arithmetic and the sampled
    values are float64 whatever the state dtype, as in the JAX package with
    x64 on (its seeds and plo are float64).  march_dtype="bfloat16" stores
    the marched vector field in bfloat16; "float32", "float64" or None keep
    the state dtype.  march_engine:
    "auto", "pallas" or "xla" (the kernel on a CUDA state, the plain
    version on a CPU state), "cuda" (the kernel: a CUDA state only) or
    "torch" (the plain version: a CPU state only).
    fetch_compress: None = the JAX default (lossy packing exactly when the
    field is bfloat16 and nRKh <= 320), True / False force it.
    defer: leave every level's payload on the device and return a
    :class:`DeferredLines` instead; ``finish()`` copies them in one copy.
    """
    if march_engine not in ENGINES:
        raise ValueError(f"march_engine={march_engine!r}: expected one of "
                         f"{', '.join(ENGINES)}")
    need = ENGINES[march_engine]
    if need is not None and dstate.device.type != need:
        raise ValueError(f"march_engine={march_engine} needs a state on "
                         f"device={need}: a CUDA state always marches "
                         "through the kernel, a CPU state through the plain "
                         "version")
    if march_dtype in ("float32", "float64", "none"):
        march_dtype = None
    if march_dtype not in (None, "bfloat16"):
        raise ValueError(f"march_dtype={march_dtype!r}: expected bfloat16, "
                         "float32, float64 or none")
    meta = dstate.meta
    dev = dstate.device
    n_half = (n_rk_steps - 1) // 2
    compress = (march_dtype == "bfloat16" and n_half <= 320
                if fetch_compress is None else bool(fetch_compress))
    if n_rk_steps % 2 == 0:
        print(f"trace_streamlines: even nRKsteps={n_rk_steps} rounds to "
              f"{2 * n_half + 1} stations (reference nRKh=(nRKsteps-1)/2)")
    fin = meta.n_levels - 1
    h_phys = h_rk * meta.geoms[fin].dx[0]
    seeds = promote_seeds(seeds, meta)
    owner = assign_seeds_to_levels(dstate, seeds)

    grad_mode = trace_field is not None
    if grad_mode:
        vec_src = [trace_field]
    else:
        vec_src = ["x_velocity", "y_velocity", "z_velocity"]
        if "z_velocity" not in dstate.names:  # DIM=2 plotfile (promoted)
            vec_src = vec_src[:2]
    comps = [dstate.comp(n) for n in vec_src + list(sample_names)]
    masks = [dstate.in_level_mask(l) for l in range(meta.n_levels)]
    all_data = [d[comps] for d in dstate.data]
    if not grad_mode and len(vec_src) == 2:
        # promote planar velocity with a zero z component
        all_data = [torch.cat([d[:2], torch.zeros_like(d[:1]), d[2:]])
                    for d in all_data]
        vec_src = vec_src + ["_zero"]
    nv = len(vec_src)
    nf = len(sample_names)
    field_dt = torch.bfloat16 if march_dtype == "bfloat16" else dstate.dtype

    out = np.zeros((len(seeds), 2 * n_half + 1, 3 + nf))
    pending = []
    for lev in range(meta.n_levels):
        sel = np.nonzero(owner == lev)[0]
        if len(sel) == 0:
            continue                      # no fill, no launch
        geom = meta.geoms[lev]
        dx = np.array(geom.dx)
        # nGrow default keeps paths sampled (stream.cpp:705); an explicit
        # override trades memory for early-frozen lines
        lev_ngrow = (ngrow if ngrow is not None
                     else int(np.ceil(h_phys * n_half / dx.min())) + 2)
        gbox = dstate.lmeta[lev].bbox.grow(lev_ngrow)
        plo_g = (np.array(geom.prob_lo)
                 + (np.array(gbox.lo) - np.array(geom.domain.lo)) * dx)
        grown = fill_dense_arrays(meta, dstate.lmeta, all_data, masks, lev,
                                  lev_ngrow, bc, "linear")
        if grad_mode:
            # the gradient is 2 cells smaller than the grown box: its
            # lower corner sits one dx further in
            vec = grad_mag(grown[0:1].contiguous(), dx, with_mag=False)
            fields = grown[nv:, 1:-1, 1:-1, 1:-1]
            plo = plo_g + dx
        else:
            vec = grown[:3]
            fields = grown[nv:]
            plo = plo_g
        field = prepare_field(vec, field_dt)
        ss = torch.from_numpy(seeds[sel]).to(dev)           # float64
        ns = len(sel)
        # +- as ONE march over doubled seeds (per-seed direction)
        dirs = torch.cat([torch.ones(ns, dtype=torch.float64, device=dev),
                          -torch.ones(ns, dtype=torch.float64, device=dev)])
        pos2, _ = march(field, plo, dx, h_phys, torch.cat([ss, ss]), n_half,
                        dirs)
        pos_p, pos_m = pos2[:, :ns], pos2[:, ns:]
        path = torch.cat([pos_m.flip(0)[:-1], pos_p]).transpose(0, 1)
        vals = (_sample_fields(fields, plo, dx, path.contiguous()) if nf
                else None)
        if compress:
            payload = _pack_compressed(path, vals, h_phys, n_half)
        else:
            payload = path if vals is None else torch.cat([path, vals], -1)
        if defer:
            pending.append((sel, payload))
        elif compress:
            _decode_compressed(payload.cpu().numpy(), sel, out, n_half, nf,
                               h_phys)
        else:
            out[sel] = payload.cpu().numpy()     # one copy per level
    if defer:
        return DeferredLines(pending, out, compress, n_half, nf, h_phys)
    return out


_NP = {torch.float64: np.float64, torch.float32: np.float32}


def _extra_dtype(t: torch.Tensor):
    """The host dtype of an extra of ``DeferredLines.finish``: the JAX
    ``_as_words`` rules (int32 and float64 kept, anything else float32)."""
    return {torch.int32: np.int32, torch.float64: np.float64}.get(
        t.dtype, np.float32)


class DeferredLines:
    """Streamline payloads left on the device (counterpart of the JAX
    ``DeferredLines``, ``stream/trace.py:551-605``):
    ``trace_streamlines(..., defer=True)`` queues every level's march and
    returns one of these.  ``finish(extra=())`` packs every level's payload
    and the caller's device tensors into one flat byte buffer on the
    device, copies it to (pinned) host memory in ONE copy and decodes it
    with the eager path's arithmetic, so the lines equal the eager ones
    bitwise.  A second ``finish`` raises."""

    def __init__(self, pending, out, compress, n_half, nf, h_phys):
        self._pending = pending        # [(sel, device payload), ...]
        self._out = out
        self._compress = compress
        self._n_half = n_half
        self._nf = nf
        self._h_phys = h_phys
        self._done = False

    def finish(self, extra=()):
        """``(lines, extras)``: the float64 lines and each extra as a numpy
        array of its shape: int32 and float64 kept, other dtypes as
        float32 (the JAX rules)."""
        if self._done:
            raise RuntimeError("DeferredLines.finish() already consumed")
        self._done = True
        extra = list(extra)
        hdt = [_extra_dtype(e) for e in extra]
        tdt = {np.int32: torch.int32, np.float64: torch.float64,
               np.float32: torch.float32}
        parts = [p for _, p in self._pending] + [
            e.to(tdt[d]) for e, d in zip(extra, hdt)]
        if not parts:                          # no seeds, no extras
            return self._out, []
        words, sizes = [], []
        for p in parts:
            b = p.contiguous().reshape(-1).view(torch.uint8)
            sizes.append(b.numel())
            words.append(b)
            if b.numel() % 8:                  # keep each part 8-aligned
                words.append(b.new_zeros(8 - b.numel() % 8))
        flat = torch.cat(words)
        if flat.device.type == "cpu":
            host = flat.numpy()
        else:
            pinned = torch.empty(flat.shape, dtype=torch.uint8,
                                 pin_memory=True)
            pinned.copy_(flat)                 # the one copy
            host = pinned.numpy()
        off, segs = 0, []
        for n in sizes:
            segs.append(host[off: off + n])
            off += -(-n // 8) * 8
        st = 2 * self._n_half + 1
        for (sel, payload), seg in zip(self._pending, segs):
            if self._compress:
                _decode_compressed(seg.view(np.int16), sel, self._out,
                                   self._n_half, self._nf, self._h_phys)
            else:
                self._out[sel] = seg.view(_NP[payload.dtype]).reshape(
                    len(sel), st, 3 + self._nf)
        extras = [seg.view(d).reshape(tuple(e.shape))
                  for seg, e, d in zip(segs[len(self._pending):], extra,
                                       hdt)]
        return self._out, extras


def promote_seeds(seeds: np.ndarray, meta) -> np.ndarray:
    """float64 seeds pushed inside the domain; DIM=2 seeds promoted to the
    z centre."""
    seeds = np.asarray(seeds, dtype=np.float64)
    if seeds.shape[1] == 2:
        g0 = meta.geoms[0]
        zc = 0.5 * (g0.prob_lo[2] + g0.prob_hi[2])
        seeds = np.concatenate(
            [seeds, np.full((len(seeds), 1), zc)], axis=1)
    return push_nodes_inside(seeds, meta.geoms[0])


def finest_cluster_of(meta, groups, points: np.ndarray) -> np.ndarray:
    """Index of the group whose finest-level boxes (of the full BoxArray)
    hold each point, -1 for none."""
    fin = meta.n_levels - 1
    geom = meta.geoms[fin]
    idx = np.floor((points - np.array(geom.prob_lo))
                   / np.array(geom.dx)).astype(np.int64) \
        + np.array(geom.domain.lo)
    out = np.full(len(points), -1, np.int64)
    boxes = meta.bas[fin]
    for gi, g in enumerate(groups):
        for i in g:
            b = boxes[i]
            out[np.all((idx >= np.array(b.lo)) & (idx <= np.array(b.hi)),
                       axis=1)] = gi
    return out


def trace_streamlines_sparse(
    base: DenseAmrState,
    fin_fabs,
    seeds: np.ndarray,
    n_rk_steps: int,
    h_rk: float,
    trace_field: Optional[str] = None,
    sample_names: Sequence[str] = (),
    bc=None,
    march_dtype: Optional[str] = None,
    march_engine: str = "auto",
    ngrow: Optional[int] = None,
    fetch_compress: Optional[bool] = None,
) -> np.ndarray:
    """Sparse refinement trace (JAX :625-767): the finest level is processed
    as dense CLUSTERS of a coarse-only ``base`` (``fin_fabs`` its per-box
    host arrays), so device memory scales with the coarse levels plus one
    cluster bbox.  Seeds are partitioned globally: a seed in a finest box
    (of the full BoxArray) marches on its cluster's substate, any other on
    the coarse levels, with h_rk rescaled to keep the physical step (h_rk
    counts the state's finest dx, stream.cpp:700).  Clusters are separated
    by the finest march's grow radius + 1, so each cluster's fill holds what
    the union-bbox fill holds around its seeds.  Clusters without seeds are
    not built.  Same arguments and output layout as
    ``trace_streamlines``."""
    meta = base.meta
    fin = meta.n_levels - 1
    n_half = (n_rk_steps - 1) // 2
    h_phys = h_rk * meta.geoms[fin].dx[0]
    ngrow_fin = (ngrow if ngrow is not None
                 else int(np.ceil(h_phys * n_half
                                  / min(meta.geoms[fin].dx))) + 2)
    groups, subs = cluster_substates(base, fin_fabs, dist=ngrow_fin + 1)
    seeds = promote_seeds(seeds, meta)
    cluster_of = finest_cluster_of(meta, groups, seeds)
    out = np.zeros((len(seeds), 2 * n_half + 1, 3 + len(sample_names)))
    kw = dict(trace_field=trace_field, sample_names=sample_names, bc=bc,
              march_dtype=march_dtype, march_engine=march_engine,
              ngrow=ngrow, fetch_compress=fetch_compress)
    sel = np.nonzero(cluster_of < 0)[0]
    if len(sel):
        coarse = coarse_only_state(base)
        h_rk_c = h_phys / coarse.meta.geoms[fin - 1].dx[0]
        out[sel] = trace_streamlines(coarse, seeds[sel], n_rk_steps, h_rk_c,
                                     **kw)
        del coarse
    for gi in range(len(groups)):
        sel = np.nonzero(cluster_of == gi)[0]
        if len(sel):
            out[sel] = trace_streamlines(subs[gi], seeds[sel], n_rk_steps,
                                         h_rk, **kw)
    return out
