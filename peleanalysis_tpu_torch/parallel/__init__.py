"""Several devices in one process: the counterpart of
``peleanalysis_tpu/parallel/``.

The JAX package is a single controller: it places arrays on the devices of
``jax.devices()`` and lets GSPMD insert the collectives.  The port stays one
process too.  A shard is a set of tensors on one ``torch.device``; every
move between shards is an explicit ``.to(device)``, a peer copy where the
shards sit on different cards.  No ``torch.distributed``: a tool needs no
launcher, and N shards may share one card (N copies of the work, one after
another), which is how the one-card runs check the partition.

  * ``mesh.py``         the shards' devices, block shape and axis names
  * ``dense_shard.py``  deep-halo windows of a hierarchy over a spatial mesh
                        (grad, curvature, isosurface) and the gather of
                        their owned cells into one plotfile
  * ``halo.py``         the explicit ring exchange and the sharded gradient
  * ``cluster_shard.py`` the clusters of a sparse level over a 1-D mesh
  * ``particles.py``    the migrating march of partStream
"""
