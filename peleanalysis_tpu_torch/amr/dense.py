"""Dense level representation on the device: one tensor per level covering
the union bounding box of that level's boxes.

    data[lev]: [ncomp, BX, BY, BZ]   (no ghosts stored; fills return grown
                                       tensors)

Counterpart of ``peleanalysis_tpu/amr/dense.py`` (``DenseAmrState``,
``DenseLevelMeta``, ``_union_mask_np``).  Each level is assembled from its
boxes on the host and copied to the device once; the masks (in_level,
covered, valid) are computed from box metadata on the host and copied over
on first use.  "Hole" cells inside the bbox but outside the level's boxes
take coarse-upsampled values in the fill, exactly like ghost cells.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .box import Box, BoxArray
from .geometry import Geometry
from ..io.fab_pack import PackedLevel, fetch_level, level_records, pack_level
from ..telemetry import count, span
from .hierarchy import (AmrMeta, _periodic_shifts, load_plotfile_fabs,
                        output_layout, write_level_records)


@dataclasses.dataclass
class DenseLevelMeta:
    bbox: Box                 # union bounding box (index space, no ghosts)
    geom: Geometry


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def covered_mask_over(meta: AmrMeta, lev: int, box: Box) -> np.ndarray:
    """bool over ``box`` (level-lev index space): the cell is covered by the
    next finer level or a periodic image of it."""
    out = np.zeros(box.shape, dtype=bool)
    if lev + 1 < meta.n_levels:
        geom = meta.geoms[lev]
        r = meta.ref_ratio[lev]
        fine = meta.bas[lev + 1]
        # the finer boxes coarsened (Box.coarsen's floor division; a
        # promoted 2-D z of 0 stays 0) and cut with box, in numpy
        lo, hi = fine.lo // r, fine.hi // r
        for sh in _periodic_shifts(geom.is_periodic, geom.domain):
            ilo = np.maximum(lo + sh, box.lo) - box.lo
            ihi = np.minimum(hi + sh, box.hi) - box.lo
            hit = (ilo <= ihi).all(axis=1)
            for a, b in zip(ilo[hit], ihi[hit]):
                out[a[0]: b[0] + 1, a[1]: b[1] + 1, a[2]: b[2] + 1] = True
    return out


def _box_slices(b: Box, bbox: Box):
    return tuple(slice(b.lo[d] - bbox.lo[d], b.hi[d] - bbox.lo[d] + 1)
                 for d in range(3))


def _union_mask_np(ba: BoxArray, bbox: Box) -> np.ndarray:
    m = np.zeros(bbox.shape, dtype=bool)
    for b in ba:
        m[_box_slices(b, bbox)] = True
    return m


def _level_metas(meta: AmrMeta) -> List[DenseLevelMeta]:
    return [DenseLevelMeta(ba.minimal_box(), g)
            for ba, g in zip(meta.bas, meta.geoms)]


def _assemble_np(ba: BoxArray, fabs, bbox: Box, np_dtype) -> np.ndarray:
    """Per-box ``[ncomp, *box.shape]`` arrays into one ``[ncomp,
    *bbox.shape]`` host array of ``np_dtype`` (holes zero)."""
    out = np.zeros((fabs[0].shape[0],) + bbox.shape, dtype=np_dtype)
    for b, fab in zip(ba, fabs):
        out[(slice(None),) + _box_slices(b, bbox)] = fab
    return out


def host_to_device(host: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``: one copy (``h2d.bytes``)
    to a card, none on the CPU."""
    t = torch.from_numpy(host)
    with span("assemble.h2d"):
        out = t.to(device)
    if out is not t:
        count("h2d.bytes", host.nbytes)
    return out


def assemble_level(ba: BoxArray, fabs, bbox: Box, dtype: torch.dtype,
                   device) -> torch.Tensor:
    """One level's boxes over ``bbox``, assembled on the host in ``dtype``
    and copied to ``device`` once."""
    with span("assemble.host"):
        host = _assemble_np(ba, fabs, bbox, _np_dtype(dtype))
    return host_to_device(host, device)


class DenseAmrState:
    """Per-level dense tensors [ncomp, *bbox_shape] on ``device``."""

    def __init__(self, meta: AmrMeta, names: Sequence[str],
                 data: List[torch.Tensor], lmeta: List[DenseLevelMeta],
                 device: torch.device):
        self.meta = meta
        self.names = list(names)
        self.data = data
        self.lmeta = lmeta
        self.device = torch.device(device)
        self._in_level_np: List[Optional[np.ndarray]] = [None] * meta.n_levels
        self._covered_np: List[Optional[np.ndarray]] = [None] * meta.n_levels
        self._masks: dict = {}
        # levels whose masks, host and device, are another state's
        # (share_masks)
        self._mask_src: dict = {}
        # the isosurface engine's per-state inputs (geom/marching_cubes.py)
        self._iso_cache: dict = {}
        # device boundary faces of the covered regions, by (lev, d), for
        # flux-matched gradients (ops/restrict.py)
        self.flux_face_masks: dict = {}

    # -- construction --------------------------------------------------------
    @classmethod
    def from_level_fabs(cls, meta: AmrMeta, names: Sequence[str],
                        level_fabs, device, dtype: torch.dtype
                        ) -> "DenseAmrState":
        """Assemble per-box ``[ncomp, *box.shape]`` arrays into one dense
        array per level on the host (rounded to ``dtype`` there), then copy
        each level to ``device`` once."""
        lmeta = _level_metas(meta)
        data = [assemble_level(meta.bas[lev], level_fabs[lev],
                               lmeta[lev].bbox, dtype, device)
                for lev in range(meta.n_levels)]
        return cls(meta, names, data, lmeta, device)

    @classmethod
    def coarse_only(cls, meta: AmrMeta, names: Sequence[str], level_fabs,
                    device, dtype: torch.dtype) -> "DenseAmrState":
        """Every level but the finest assembled on ``device``;
        ``data[finest]`` is None and its union bbox is metadata only, so
        nothing of that size is ever allocated.  The base of the sparse
        refinement path (amr/cluster.py): its coarse masks see the full
        finest BoxArray."""
        lmeta = _level_metas(meta)
        fin = meta.n_levels - 1
        data = [assemble_level(meta.bas[lev], level_fabs[lev],
                               lmeta[lev].bbox, dtype, device)
                for lev in range(fin)] + [None]
        return cls(meta, names, data, lmeta, device)

    @classmethod
    def from_plotfile(cls, path: str, device, names=None, max_level=None,
                      is_periodic=None, dtype: torch.dtype = torch.float32
                      ) -> "DenseAmrState":
        meta, names, fabs = load_plotfile_fabs(path, names, max_level,
                                               is_periodic)
        return cls.from_level_fabs(meta, names, fabs, device, dtype)

    @classmethod
    def from_numpy(cls, domains, prob_lo, prob_hi, is_periodic, ref_ratio,
                   boxes, names, level_arrays, device,
                   dtype: torch.dtype) -> "DenseAmrState":
        """A state from plain tuples and numpy arrays.

        domains[lev] and boxes[lev][i] are ``(lo, hi)`` index tuples;
        level_arrays[lev] is the dense ``[ncomp, *bbox_shape]`` array over
        the union bbox of boxes[lev] (holes included)."""
        geoms = [Geometry(Box(*dom), prob_lo, prob_hi, is_periodic)
                 for dom in domains]
        bas = [BoxArray([Box(lo, hi) for lo, hi in bl]) for bl in boxes]
        meta = AmrMeta(geoms, bas, list(ref_ratio))
        lmeta = _level_metas(meta)
        data = []
        for lev, arr in enumerate(level_arrays):
            want = (len(names),) + lmeta[lev].bbox.shape
            if tuple(arr.shape) != want:
                raise ValueError(f"level {lev} array shape {arr.shape} != "
                                 f"{want}")
            host = np.array(arr, dtype=_np_dtype(dtype))   # own, writable
            data.append(host_to_device(host, device))
        return cls(meta, names, data, lmeta, device)

    # -- masks ---------------------------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        return self.data[0].dtype

    def share_masks(self, src: "DenseAmrState", levels) -> None:
        """Take the in-level, covered and valid masks of ``levels``, host
        and device, from ``src``, whose levels have the same bboxes: a
        cluster substate's coarse levels then see the GLOBAL covered masks,
        and every substate uses the one device copy of each."""
        for lev in levels:
            self._in_level_np[lev] = src.in_level_mask_np(lev)
            self._covered_np[lev] = src.covered_mask_np(lev)
            self._mask_src[lev] = src

    def in_level_mask_np(self, lev: int) -> np.ndarray:
        """bool [*bbox_shape]: cell covered by this level's boxes."""
        if self._in_level_np[lev] is None:
            self._in_level_np[lev] = _union_mask_np(self.meta.bas[lev],
                                                    self.lmeta[lev].bbox)
        return self._in_level_np[lev]

    def covered_mask_np(self, lev: int) -> np.ndarray:
        """bool: cell covered by the NEXT finer level (+periodic images)."""
        if self._covered_np[lev] is None:
            self._covered_np[lev] = covered_mask_over(self.meta, lev,
                                                      self.lmeta[lev].bbox)
        return self._covered_np[lev]

    def valid_mask_np(self, lev: int) -> np.ndarray:
        return self.in_level_mask_np(lev) & ~self.covered_mask_np(lev)

    def _device_mask(self, kind: str, lev: int) -> torch.Tensor:
        if lev in self._mask_src:
            return self._mask_src[lev]._device_mask(kind, lev)
        key = (kind, lev)
        if key not in self._masks:
            host = getattr(self, f"{kind}_mask_np")(lev)
            self._masks[key] = host_to_device(host, self.device)
        return self._masks[key]

    def in_level_mask(self, lev: int) -> torch.Tensor:
        return self._device_mask("in_level", lev)

    def covered_mask(self, lev: int) -> torch.Tensor:
        return self._device_mask("covered", lev)

    def valid_mask(self, lev: int) -> torch.Tensor:
        return self._device_mask("valid", lev)

    def comp(self, name: str) -> int:
        return self.names.index(name)

    def with_data(self, names: Sequence[str],
                  data: List[torch.Tensor]) -> "DenseAmrState":
        st = DenseAmrState(self.meta, names, data, self.lmeta, self.device)
        st._in_level_np = self._in_level_np
        st._covered_np = self._covered_np
        st._masks = self._masks
        st._mask_src = self._mask_src
        st.flux_face_masks = self.flux_face_masks
        return st

    # -- back to a plotfile ---------------------------------------------------
    def level_fabs(self) -> List[List[np.ndarray]]:
        """Per-level lists of each box's C-contiguous ``[ncomp,
        *box.shape]`` copy, as the JAX package's packed dense writer gives
        them; each level is copied to the host once.  With
        ``write_level_fabs``, the plain host version of ``to_plotfile``."""
        out = []
        for lev in range(self.meta.n_levels):
            host = self.data[lev].cpu().numpy()
            bbox = self.lmeta[lev].bbox
            out.append([np.ascontiguousarray(
                host[(slice(None),) + _box_slices(b, bbox)])
                for b in self.meta.bas[lev]])
        return out

    def packed_level(self, lev: int, dtype=np.float64) -> PackedLevel:
        """Level ``lev``'s FAB records of ``dtype`` and their min/max
        tables, packed in file order on the state's device."""
        bbox = self.lmeta[lev].bbox
        return pack_level(self.data[lev], [_box_slices(b, bbox)
                                           for b in self.meta.bas[lev]],
                          dtype)

    def to_plotfile(self, path: str, names=None, dtype=np.float64) -> None:
        """Write the state as a plotfile of ``dtype`` FABs.  Each level is
        sliced, permuted, cast and reduced to its min/max tables on the
        state's device and copied to the host in one copy
        (``io/fab_pack.py``); the files equal
        ``write_level_fabs(meta, names, self.level_fabs(), path, dtype)``
        byte for byte."""
        out = PlotfileRecords(self.meta, names or self.names, dtype)
        for lev in range(self.meta.n_levels):
            out.add(lev, self.data[lev], self.lmeta[lev].bbox,
                    range(len(self.meta.bas[lev])))
        out.write(path)

    def to_plotfile_async(self, path: str, submit, names=None,
                          dtype=np.float64) -> None:
        """``to_plotfile`` with the host half on another thread: each
        level is packed on the state's device and its copy into a fresh
        pinned buffer started here; ``submit`` gets a thunk that waits on
        each copy's CUDA event, then files the records and writes the
        plotfile (host work only: no launch, no allocation on the card).
        The files equal ``to_plotfile``'s byte for byte."""
        out = PlotfileRecords(self.meta, names or self.names, dtype)
        pending = [out.start(lev, self.data[lev], self.lmeta[lev].bbox,
                             range(len(self.meta.bas[lev])))
                   for lev in range(self.meta.n_levels)]

        def write():
            for finish in pending:
                finish()
            out.write(path)

        submit(write)


class PlotfileRecords:
    """A plotfile of ``meta``'s boxes gathered part by part: each ``add``
    packs some boxes of one level out of one dense tensor on its device
    (one ``pack_level``) and copies them to pinned host memory (one copy),
    then files each box's record at its index in the BoxArray.  ``write``
    writes the records in file order.  The sparse refinement path adds the
    coarse levels from the coarse pass and each cluster's finest boxes from
    that cluster's output, so no tensor spans the finest union bbox; the
    files equal ``write_level_fabs`` of the same per-box values byte for
    byte, as ``to_plotfile``'s do."""

    def __init__(self, meta: AmrMeta, names: Sequence[str], dtype=np.float64):
        self.meta = meta
        self.names = list(names)
        self.dtype = dtype
        self._shapes = [[b.shape for b in ba] for ba in output_layout(meta)[1]]
        self._records = [[None] * len(ba) for ba in meta.bas]

    def add(self, lev: int, data: torch.Tensor, bbox: Box, idx) -> None:
        """Boxes ``idx`` of level ``lev`` from ``data [ncomp, *bbox.shape]``
        (index space of ``bbox``)."""
        self.start(lev, data, bbox, idx)()

    def start(self, lev: int, data: torch.Tensor, bbox: Box, idx):
        """``add``, split at the copy: packs the boxes and starts their
        copy to the host, and returns the thunk that waits for it and files
        the records (``fab_pack.fetch_level``)."""
        idx = list(idx)
        boxes = self.meta.bas[lev]
        packed = pack_level(data, [_box_slices(boxes[i], bbox) for i in idx],
                            self.dtype)
        host, wait = fetch_level(packed)

        def finish():
            wait()
            payloads, mins, maxs = level_records(
                packed, host, [self._shapes[lev][i] for i in idx])
            for k, i in enumerate(idx):
                self._records[lev][i] = (payloads[k], mins[k], maxs[k])

        return finish

    def write(self, path: str) -> None:
        missing = [(lev, i) for lev, recs in enumerate(self._records)
                   for i, r in enumerate(recs) if r is None]
        if missing:
            raise ValueError(f"no record for (level, box) {missing[:4]}")
        write_level_records(self.meta, self.names, [
            ([r[0] for r in recs], np.stack([r[1] for r in recs]),
             np.stack([r[2] for r in recs])) for recs in self._records],
            path, self.dtype)
