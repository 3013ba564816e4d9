"""``partStream`` — particle-style streamlines along the velocity field.

Counterpart of ``peleanalysis_tpu/tools/part_stream.py``, itself the
replacement for the reference's Src/partStream.cpp + StreamPC.{H,cpp}: the
reference moves particles with an AMReX ParticleContainer, here every line
is marched at once by the ``stream`` engine (``stream/trace.py``), so each
seeded level is one launch of the march kernel on the card.  Seeds come
from oneSeedPerCell (every valid finest cell, thinned by seedStride), an
isoFile MEF, seedLoc or a seed rake.  Outputs: Tecplot lines (outFile),
an AMReX particle plotfile whose particles sit at the lines' last station
and carry every station as ``path_###_{x,y,z}`` reals (partFile), and
StreamData (streamFile).

The plotfile loads in float64 whatever ``dtype=``.  Sparse refinement (the
finest union bbox wasting >4x its cells) traces cluster by cluster, gated
as in the JAX tool: oneSeedPerCell=1, force_dense=1 and ndevices>1 take
the dense path.  ``ndevices=N`` (JAX :77-88) runs the migrating march
(``parallel/particles.py``) over a 1-D "parts" mesh of N shards: each
level's grown field cut into N X slabs, one march launch a slab a step,
the lines moving to the slab that owns them after every step
(``capacity=`` caps the lines a slab holds); the lines are the one-device
run's, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..amr.cluster import clustered
from ..amr.dense import DenseAmrState
from ..io.particles import write_particles
from ..io.stream_data import StreamData, compute_inside_nodes, write_stream_data
from ..parallel.mesh import make_mesh
from ..parallel.particles import AXIS, trace_streamlines_migrating
from ..parmparse import ParmParse
from ..session import dense_state, load_state, var_names
from ..stream.trace import trace_streamlines, trace_streamlines_sparse
from .grad import refuse_unported
from .stream import get_seeds, write_tecplot_lines


def seeds_one_per_cell(ds: DenseAmrState, stride: int = 1) -> np.ndarray:
    """Seed at every valid finest-level cell center (partStream.cpp:8-40);
    optional stride thins the cloud."""
    lev = ds.meta.n_levels - 1
    geom = ds.meta.geoms[lev]
    bbox = ds.lmeta[lev].bbox
    m = ds.in_level_mask_np(lev)
    idx = np.argwhere(m)[::stride]
    dx = np.array(geom.dx)
    return (np.array(geom.prob_lo)
            + (idx + np.array(bbox.lo) - np.array(geom.domain.lo) + 0.5) * dx)


def write_part_file(path: str, lines: np.ndarray) -> None:
    """AMReX particle plotfile (StreamPC's WritePlotFile analog): the
    particle position is the final path point; the whole path rides in the
    runtime real comps (StreamPC.cpp:14-35, Nsteps*SPACEDIM reals)."""
    real_comps = {}
    for j in range(lines.shape[1]):
        for d, ax in enumerate("xyz"):
            real_comps[f"path_{j:03d}_{ax}"] = lines[:, j, d]
    write_particles(path, lines[:, -1, :3], real_comps=real_comps)


def main(args: dict) -> None:
    """CLI: partStream infile= [oneSeedPerCell=1 [seedStride=1] | isoFile= |
    seedLoc= | seedRakeL= seedRakeR= [seedRakeNum=10]] [Nsteps=51] [hRK=0.1]
    [nGrow=] [finestLevel=] [outFile=<infile>_stream.dat] [partFile=]
    [streamFile=] [force_dense=0] [ndevices=1 [capacity=]]
    [device=cuda|cpu].  Loads float64 whatever dtype=."""
    pp = ParmParse(args)
    infile = pp.get_str("infile")
    n_steps = pp.query_int("Nsteps", 51)
    h_rk = pp.query_float("hRK", 0.1)
    one_per_cell = pp.query_bool("oneSeedPerCell", False)
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)

    vel = [v for v in ("x_velocity", "y_velocity", "z_velocity")
           if v in var_names(args, infile)]
    src = load_state(args, infile, names=vel,
                     max_level=pp.query_int("finestLevel", None),
                     dtype=torch.float64, device=device)
    meta, fabs = src.meta, src.fabs
    ndev = pp.query_int("ndevices", 1)
    sparse = (clustered(meta, pp, [meta.n_levels - 1]) and not one_per_cell
              and ndev <= 1)
    ds = (DenseAmrState.coarse_only(meta, src.names, fabs, device,
                                    torch.float64) if sparse
          else dense_state(args, src, device, torch.float64))

    elements = np.zeros((0, 3), np.int32)
    if one_per_cell:
        seeds = seeds_one_per_cell(ds, pp.query_int("seedStride", 1))
    else:
        seeds, get_elts = get_seeds(pp)
        elements = get_elts()

    if ndev > 1:
        # the Redistribute path (StreamPC.cpp:86-141): per-step migration
        lines = trace_streamlines_migrating(
            ds, seeds, n_steps, h_rk, make_mesh(ndev, device,
                                                axis_names=(AXIS,)),
            capacity=pp.query_int("capacity", None))
    elif sparse:
        print("partStream: sparse refinement detected -> clustered path")
        lines = trace_streamlines_sparse(ds, fabs[-1], seeds, n_steps, h_rk,
                                         trace_field=None, sample_names=())
    else:
        lines = trace_streamlines(ds, seeds, n_steps, h_rk, trace_field=None,
                                  sample_names=(),
                                  ngrow=pp.query_int("nGrow", None))
    del ds
    names = ["X", "Y", "Z"]
    out = pp.query_str("outFile", infile + "_stream.dat")
    write_tecplot_lines(out, names, lines)
    print(f"wrote {out} ({lines.shape[0]} lines)")
    if pp.contains("partFile"):
        write_part_file(pp.get_str("partFile"), lines)
        print(f"wrote {pp.get_str('partFile')}/particles")
    if pp.contains("streamFile"):
        inside = compute_inside_nodes(meta, lines[:, lines.shape[1] // 2, :3])
        write_stream_data(pp.get_str("streamFile"),
                          StreamData(names, np.asarray(elements, np.int32),
                                     inside, lines))
        print(f"wrote {pp.get_str('streamFile')}")
