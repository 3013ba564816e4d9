"""The clusters of a sparse finest level over a 1-D "clusters" mesh.

Counterpart of ``peleanalysis_tpu/parallel/cluster_shard.py``.  The JAX
package stacks equal-bucket canonical clusters on a batch axis, ``vmap``s
the per-cluster engine over it and shards the batch over the mesh: device
j of n holds batch rows ``j*ceil(K/n)`` .. ``(j+1)*ceil(K/n) - 1``.  The port
has no canonical frames (``amr/cluster.py``), so every cluster takes this
path: cluster j goes to the shard that owns JAX's batch row j, its
substate built on that shard's device (``amr/cluster.cluster_substates``)
over a copy of the coarse-only base made once a device, and the clusters
run one after another.  The outputs do not depend on where a cluster ran,
so the files are the one-device run's.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Tuple

import torch

from ..amr.cluster import Substates, cluster_substates
from ..amr.dense import DenseAmrState
from .mesh import Mesh, make_mesh

CLUSTER_AXIS = "clusters"


def cluster_mesh(n: int, device=None) -> Mesh:
    """1-D mesh over the cluster axis (the DistributionMapping rank set)."""
    return make_mesh(n, device, axis_names=(CLUSTER_AXIS,))


def cluster_shard(j: int, n_clusters: int, mesh: Mesh) -> int:
    """The shard of cluster j: JAX's batch row j of ``ceil(K/n)`` rows a
    device."""
    return j // -(-n_clusters // mesh.size)


def base_on(base: DenseAmrState, device) -> DenseAmrState:
    """A coarse-only base state's copy on ``device`` (its host masks
    shared, its device masks built there)."""
    device = torch.device(device)
    if device == base.device:
        return base
    fin = base.meta.n_levels - 1
    ds = DenseAmrState(base.meta, base.names,
                       [d.to(device) for d in base.data[:fin]] + [None],
                       base.lmeta, device)
    for lev in range(fin):
        ds._in_level_np[lev] = base.in_level_mask_np(lev)
        ds._covered_np[lev] = base.covered_mask_np(lev)
    return ds


class ShardedSubstates(Substates):
    """``cluster_substates`` with cluster j built on its shard's device
    (``cluster_shard``); ``bases`` holds the base on each device."""

    def __init__(self, base: DenseAmrState, fin_fabs, mesh: Mesh,
                 dist: int = 2):
        self.bases: Dict[torch.device, DenseAmrState] = {}
        per_dev = {}
        for dev in mesh.devices:
            if dev not in self.bases:
                self.bases[dev] = base_on(base, dev)
                per_dev[dev] = cluster_substates(self.bases[dev], fin_fabs,
                                                 dist)
        groups = next(iter(per_dev.values()))[0]
        self._subs = per_dev
        self._mesh = mesh
        super().__init__(groups, None)

    def device_of(self, j: int) -> torch.device:
        return self._mesh.devices[cluster_shard(j, len(self.groups),
                                                self._mesh)]

    def __getitem__(self, j: int) -> DenseAmrState:
        return self._subs[self.device_of(j)][1][j]

    def __iter__(self):
        for j in range(len(self.groups)):
            yield self[j]


def sharded_substates(base: DenseAmrState, fin_fabs, mesh: Mesh = None,
                      dist: int = 2):
    """(groups, substates): ``cluster_substates``, or with a mesh each
    cluster on its shard's device."""
    if mesh is None:
        return cluster_substates(base, fin_fabs, dist)
    subs = ShardedSubstates(base, fin_fabs, mesh, dist)
    return subs.groups, subs


def run_clusters_sharded(base: DenseAmrState, fin_fabs,
                         fn: Callable[[DenseAmrState], object],
                         mesh: Mesh = None, dist: int = 2
                         ) -> Iterator[Tuple[List[int], object]]:
    """``(group, fn(substate))`` of every cluster in order, each substate on
    its shard's device and freed before the next is built."""
    groups, subs = sharded_substates(base, fin_fabs, mesh, dist)
    for g, sub in zip(groups, subs):
        yield g, fn(sub)
        del sub
