"""Box clustering for sparse refinement.

Counterpart of ``peleanalysis_tpu/amr/cluster.py`` and of
``coarse_only_state`` (``peleanalysis_tpu/amr/canonical.py:612``).  The
dense model (amr/dense.py) stores each level over the union bounding box of
its boxes.  A PeleLM/PeleC finest level follows a flame front and covers a
few percent of the domain in scattered regions, so its union bbox can be
orders of magnitude larger than its cells.  Tools split such a level into
CLUSTERS -- connected components of the BoxArray (boxes within an
interaction distance of each other), greedily merged while the merged bbox
stays full enough -- and process one dense patch per cluster: device memory
scales with the coarse levels plus one cluster bbox.  The reference gets
this from per-rank box ownership (Src/grad.cpp:160-163).

Every cluster is a *legacy substate* (``cluster_substates``, JAX :169): the
coarse levels' device tensors of one coarse-only base state, shared with no
copy; the finest level assembled over the cluster's bbox; the coarse levels'
in-level and covered masks the GLOBAL ones, so no cluster sees coarse cells
under another cluster's boxes as uncovered.  The JAX package's canonical
frames and bucket padding (``amr/canonical.py``, ``_pad_single_level``)
exist to share XLA compiles and are not ported.  Substates are built one at
a time, when a caller visits them (``Substates``), and freed with the
caller's reference.  Pointwise tools (the chemistry verbs) need no coarse
context and take ``level_parts``: each level whole, or a sparse level
cluster by cluster, with the global valid masks.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np

from ..parmparse import ParmParse
from .box import Box, BoxArray
from .dense import (DenseAmrState, DenseLevelMeta, _level_metas,
                    assemble_level)
from .hierarchy import AmrMeta


def connected_components(ba: BoxArray, dist: int = 2) -> List[List[int]]:
    """Union-find over boxes closer than ``dist`` cells (any overlap of
    grow(a, dist) with b).  dist=2 covers the 1-ghost fill plus the 1-cell
    dual-grid reach, so separate components never see each other's data."""
    n = len(ba)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        # the boxes j > i that grow(box i, dist) meets, in ascending order
        hit = np.all((ba.lo[i + 1:] <= ba.hi[i] + dist)
                     & (ba.hi[i + 1:] >= ba.lo[i] - dist), axis=1)
        for j in np.nonzero(hit)[0] + i + 1:
            ri, rj = find(i), find(int(j))
            if ri != rj:
                parent[ri] = rj
    comps: dict = {}
    for i in range(n):
        comps.setdefault(find(i), []).append(i)
    return list(comps.values())


def cluster_boxes(ba: BoxArray, waste_factor: float = 4.0,
                  dist: int = 2) -> List[List[int]]:
    """Connected components, then greedy merging of components while the
    merged bounding box wastes less than ``waste_factor`` x the contained
    cells.  Returns lists of box indices (each a dense patch)."""
    comps = connected_components(ba, dist)
    boxes = list(ba)

    def bbox_of(idxs):
        lo = np.min([boxes[i].lo for i in idxs], axis=0)
        hi = np.max([boxes[i].hi for i in idxs], axis=0)
        return Box(tuple(lo), tuple(hi))

    def cells_of(idxs):
        return sum(boxes[i].size for i in idxs)

    # sort components by bbox lo corner for deterministic greedy merging
    comps.sort(key=lambda c: bbox_of(c).lo)
    merged: List[List[int]] = []
    for comp in comps:
        if merged:
            cand = merged[-1] + comp
            if bbox_of(cand).size <= waste_factor * cells_of(cand):
                merged[-1] = cand
                continue
        merged.append(list(comp))
    return merged


def needs_clustering(ba: BoxArray) -> bool:
    """True when the union bbox wastes more than 4x the valid cells AND holds
    more than 2^21 cells, enough for the waste to matter."""
    bbox = ba.minimal_box()
    return bbox.size > 4 * ba.total_cells() and bbox.size > 1 << 21


def clustered(meta: AmrMeta, pp: ParmParse, levels: Sequence[int],
              force: bool = False) -> bool:
    """Whether a tool takes the sparse refinement path: more than one level,
    no ``force_dense=1``, and one of ``levels`` wasting >4x its cells in its
    union bbox (``needs_clustering``) or ``force`` (isosurface's
    ``surface_is_large=1``)."""
    return (meta.n_levels > 1 and not pp.query_bool("force_dense", False)
            and (force or any(needs_clustering(meta.bas[l])
                              for l in levels)))


class Substates:
    """A sequence of per-group dense states, each built when it is visited
    (``subs[i]`` or iteration) and held only by the caller: visiting one
    twice builds it twice."""

    def __init__(self, groups: Sequence[Sequence[int]],
                 build: Callable[[Sequence[int]], DenseAmrState]):
        self.groups = [list(g) for g in groups]
        self._build = build

    def __len__(self) -> int:
        return len(self.groups)

    def __getitem__(self, i: int) -> DenseAmrState:
        return self._build(self.groups[i])

    def __iter__(self):
        for g in self.groups:
            yield self._build(g)


def _group_array(meta: AmrMeta, g: Sequence[int]) -> BoxArray:
    boxes = meta.bas[-1]
    return BoxArray([boxes[i] for i in g])


def cluster_substates(base: DenseAmrState, fin_fabs, dist: int = 2):
    """Per-cluster dense states for stencil tools over a coarse-only
    ``base`` (``DenseAmrState.coarse_only``): coarse tensors shared with no
    copy, the finest level assembled per cluster from ``fin_fabs`` (the
    finest level's per-box host arrays), coarse in-level/covered masks the
    GLOBAL ones.  Cluster separation (``dist``, connected_components)
    guarantees that one cluster's fills never reach another cluster's fine
    data, so per-cluster outputs equal the global dense run on every cluster
    cell.  Returns (groups, substates); groups[i] lists the finest-level box
    indices of substates[i]."""
    meta = base.meta
    fin = meta.n_levels - 1
    groups = cluster_boxes(meta.bas[fin], dist=dist)

    def build(g):
        ba_g = _group_array(meta, g)
        bbox_g = ba_g.minimal_box()
        meta_g = AmrMeta(meta.geoms, meta.bas[:fin] + [ba_g], meta.ref_ratio,
                         meta.time, meta.level_steps, meta.ndim2)
        lmeta_g = base.lmeta[:fin] + [DenseLevelMeta(bbox_g, meta.geoms[fin])]
        data_g = base.data[:fin] + [assemble_level(
            ba_g, [fin_fabs[i] for i in g], bbox_g, base.dtype, base.device)]
        sub = DenseAmrState(meta_g, base.names, data_g, lmeta_g, base.device)
        sub.share_masks(base, range(fin))
        return sub

    return groups, Substates(groups, build)


def coarse_only_state(base: DenseAmrState) -> DenseAmrState:
    """Levels 0..fin-1 of a coarse-only ``base`` as a hierarchy of their own
    (the coarse pass beside the cluster runs), its tensors and masks the
    base's: level fin-1's covered mask comes from the FULL hierarchy, so
    fine-covered cells are excluded exactly as in a global run."""
    meta = base.meta
    fin = meta.n_levels - 1
    meta_c = AmrMeta(meta.geoms[:fin], meta.bas[:fin],
                     meta.ref_ratio[:fin - 1], meta.time,
                     meta.level_steps[:fin] if meta.level_steps else None,
                     meta.ndim2)
    ds = DenseAmrState(meta_c, base.names, base.data[:fin], base.lmeta[:fin],
                       base.device)
    ds.share_masks(base, range(fin))
    return ds


def sparse_stats_parts(base: DenseAmrState, fin_fabs):
    """Decompose a sparse hierarchy for the statistics tools
    (conditionalMean, jpdf): (coarse, clusters, fine_ratio) where

      coarse      levels 0..fin-1 (``coarse_only_state``), with the GLOBAL
                  fine-covered mask on its finest level
      clusters    single-level dense states, one per finest-level cluster,
                  built when visited (footprint ~ one cluster bbox)
      fine_ratio  ref ratio fin-1 -> fin (the weight rescale for tools whose
                  per-cell weights count finest-equivalent cells)

    Accumulating a masked statistic over coarse + every cluster visits the
    valid cells of the full hierarchy exactly once each."""
    meta = base.meta
    fin = meta.n_levels - 1
    groups = cluster_boxes(meta.bas[fin])

    def build(g):
        ba_g = _group_array(meta, g)
        bbox_g = ba_g.minimal_box()
        meta_g = AmrMeta([meta.geoms[fin]], [ba_g], [], meta.time, None,
                         meta.ndim2)
        data = [assemble_level(ba_g, [fin_fabs[i] for i in g], bbox_g,
                               base.dtype, base.device)]
        return DenseAmrState(meta_g, base.names, data,
                             [DenseLevelMeta(bbox_g, meta.geoms[fin])],
                             base.device)

    return (coarse_only_state(base), Substates(groups, build),
            meta.ref_ratio[fin - 1])


def level_parts(meta: AmrMeta, names: Sequence[str], level_fabs, device,
                dtype):
    """A pointwise tool's parts, one at a time: each level over its union
    bbox, or, where that bbox wastes >4x the level's cells
    (``needs_clustering``), each cluster of the level's boxes over the
    cluster's bbox, so no tensor spans a sparse level's union bbox.  Yields
    (lev, idx, part): ``part`` is a state of ``meta``'s hierarchy whose
    level ``lev`` holds the boxes ``idx`` of ``level_fabs[lev]`` (assembled
    on ``device`` in ``dtype``; the other levels' data None), and whose
    ``valid_mask(lev)`` is the global one (cells covered by level lev + 1
    excluded)."""
    for lev in range(meta.n_levels):
        ba = meta.bas[lev]
        groups = (cluster_boxes(ba) if needs_clustering(ba)
                  else [list(range(len(ba)))])
        for g in groups:
            ba_g = BoxArray([ba[i] for i in g])
            meta_g = AmrMeta(meta.geoms, meta.bas[:lev] + [ba_g]
                             + meta.bas[lev + 1:], meta.ref_ratio, meta.time,
                             meta.level_steps, meta.ndim2)
            lmeta = _level_metas(meta_g)
            data = [None] * meta.n_levels
            data[lev] = assemble_level(ba_g, [level_fabs[lev][i] for i in g],
                                       lmeta[lev].bbox, dtype, device)
            yield lev, g, DenseAmrState(meta_g, names, data, lmeta, device)
