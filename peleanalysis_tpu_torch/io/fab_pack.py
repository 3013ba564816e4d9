"""A dense level's FAB records, packed on the state's device.

The device half of ``DenseAmrState.to_plotfile``.  For one level,
``pack_level`` slices every box window, permutes it to the file's
``[comp, k, j, i]`` order, casts it to the output dtype and packs the boxes
in file order into one flat buffer; the buffer's tail holds each box's
per-component min and max of the cast values.  ``fetch_level`` starts the
buffer's one copy to (pinned) host memory, and ``level_records`` turns it
into the FAB payloads, as views, and the ``_H`` min/max tables for
``io/plotfile.py`` ``write_plotfile_records``.  The JAX package's packed
dense writer (``peleanalysis_tpu/amr/dense.py`` ``_packed_dev``) also
fetches the windows in one transfer, but casts and reduces on the host.

The bytes equal those of ``write_plotfile`` given each box as a
C-contiguous ``[comp, i, j, k]`` array (``DenseAmrState.level_fabs``):

* a cast keeps a NaN's sign and payload on the card as on the host (the
  H100's float32 <-> float64 conversions do; ``chip_smoke.py`` holds the
  bytes of a float32 curvature with NaN cells);
* a min or max of zero gets numpy's sign.  The card's reduction may pick
  either zero where both signs are present, and numpy's pick depends on its
  SIMD path, so only such entries are settled on the host by numpy's own
  reduction over the C-contiguous box.  Zeros of one sign settle without
  it: a second min/max, of the values' integer bits, tells which signs of
  zero a box holds (``-0.0`` is the smallest integer of all floats).
* a box holding a NaN has a NaN min and max (``torch.aminmax`` and
  ``ndarray.min`` both propagate it); the table prints ``nan`` either way.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..telemetry import count, span

_INT = {torch.float64: torch.int64, torch.float32: torch.int32}


@dataclasses.dataclass
class PackedLevel:
    """One level's packed buffer: ``flat[:payload]`` the records' values in
    file order, then four ``[nbox, ncomp]`` tables: min, max (the cast
    values) and min, max of the same values' integer bits."""
    flat: torch.Tensor
    ncomp: int
    offsets: List[int]         # each box's first element in flat
    payload: int               # elements of all records

    @property
    def nbox(self) -> int:
        return len(self.offsets)


def torch_dtype(dtype) -> torch.dtype:
    return {np.dtype(np.float64): torch.float64,
            np.dtype(np.float32): torch.float32}[np.dtype(dtype)]


def pack_level(data: torch.Tensor, windows: Sequence[Tuple[slice, ...]],
               dtype) -> PackedLevel:
    """Pack the box ``windows`` (index slices over data's last three
    axes) of one level ``data [ncomp, BX, BY, BZ]`` as FAB records of
    ``dtype``, on data's device.  Nothing is waited for."""
    out_t = torch_dtype(dtype)
    ncomp = data.shape[0]
    shapes = [tuple(s.stop - s.start for s in w) for w in windows]
    sizes = [ncomp * int(np.prod(s)) for s in shapes]
    offsets = [int(o) for o in np.cumsum([0] + sizes[:-1])]
    payload, nt = sum(sizes), len(windows) * ncomp
    flat = torch.empty(payload + 4 * nt, dtype=out_t, device=data.device)
    for w, s, off, n in zip(windows, shapes, offsets, sizes):
        flat[off: off + n].view(ncomp, *s[::-1]).copy_(
            data[(slice(None),) + tuple(w)].permute(0, 3, 2, 1))
    tables = [[], [], [], []]
    ity = _INT[out_t]
    for off, n in zip(offsets, sizes):
        v = flat[off: off + n].view(ncomp, -1)
        for t, r in zip(tables, (*torch.aminmax(v, dim=1),
                                 *torch.aminmax(v.view(ity), dim=1))):
            t.append(r)
    for k, t in enumerate(tables):
        dst = flat[payload + k * nt: payload + (k + 1) * nt]
        torch.stack(t, out=(dst.view(ity) if k >= 2 else dst)
                    .view(len(windows), ncomp))
    return PackedLevel(flat, ncomp, offsets, payload)


def fetch_level(packed: PackedLevel):
    """Start the packed buffer's copy to the host: ``(host, wait)``, where
    ``host`` holds the buffer once ``wait()`` has returned.  From a card
    the copy goes into a fresh pinned buffer (never reused across calls)
    and ``wait`` blocks on a CUDA event recorded after it, so another host
    thread may call it (the session's write-back does): it launches
    nothing and allocates nothing on the card.  The caller keeps
    ``packed`` referenced until ``wait()`` has returned.  On the CPU the
    buffer is the host array and ``wait`` returns at once.  The copy counts
    in ``d2h.bytes``, the wait is the span ``writeback.wait``."""
    if packed.flat.device.type == "cpu":
        return packed.flat.numpy(), lambda: None
    host = torch.empty(packed.flat.shape, dtype=packed.flat.dtype,
                       pin_memory=True)
    host.copy_(packed.flat, non_blocking=True)
    count("d2h.bytes", host.numel() * host.element_size())
    done = torch.cuda.Event()
    done.record()

    def wait():
        with span("writeback.wait"):
            done.synchronize()

    return host.numpy(), wait


def level_records(packed: PackedLevel, host: np.ndarray,
                  shapes: Sequence[Tuple[int, ...]]):
    """``(payloads, mins, maxs)`` of one level for
    ``write_plotfile_records``: payloads[i] a view of ``host``, the tables
    float64 ``[nbox, ncomp]`` with each zero's sign settled as numpy's
    reduction of the C-contiguous box settles it.  ``shapes`` are the
    boxes' shapes as written (DIM=2 boxes without their z)."""
    nc, nb, p = packed.ncomp, packed.nbox, packed.payload
    nt = nb * nc
    sizes = [nc * int(np.prod(s)) for s in shapes]
    payloads = [host[o: o + n] for o, n in zip(packed.offsets, sizes)]
    mins, maxs = (host[p + k * nt: p + (k + 1) * nt].reshape(nb, nc)
                  .astype(np.float64) for k in range(2))
    ity = np.int64 if host.dtype == np.float64 else np.int32
    imin, imax = (host[p + k * nt: p + (k + 1) * nt].view(ity)
                  .reshape(nb, nc) for k in (2, 3))
    neg0 = imin == np.iinfo(ity).min           # the box holds a -0.0
    for i, c in zip(*np.nonzero((mins == 0) | (maxs == 0))):
        if mins[i, c] == 0:
            mins[i, c] = (float(_c_order(payloads[i], shapes[i], c).min())
                          if neg0[i, c] else 0.0)
        if maxs[i, c] == 0:
            # every value is <= 0: +0.0 has the largest integer bits
            pos0 = imax[i, c] == 0
            maxs[i, c] = (float(_c_order(payloads[i], shapes[i], c).max())
                          if neg0[i, c] and pos0 else 0.0 if pos0 else -0.0)
    return payloads, mins, maxs


def _c_order(payload: np.ndarray, shape: Tuple[int, ...], c: int):
    """Component c of a record as the host writer reduces it: a
    C-contiguous ``[i, j(, k)]`` array."""
    nc = payload.size // int(np.prod(shape))
    return np.ascontiguousarray(payload.reshape((nc,) + tuple(shape[::-1]))
                                [c].T)
