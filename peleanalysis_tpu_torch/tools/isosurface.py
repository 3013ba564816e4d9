"""``isosurface`` — marching-cubes isosurface of a plotfile variable -> MEF.

Counterpart of ``peleanalysis_tpu/tools/isosurface.py`` (dense path, the
enum engine), itself the replacement for the reference's
Src/isosurface.cpp.  CLI keys follow isosurface.cpp:1295-1399,1894-2238:
infile, isoCompName (default temp), isoVal, comps / sComp+nComp (extra node
fields), finestLevel, is_per, writeSurf, surfFormat=MEF|DAT|XDMF,
outfile_base, computeArea.  The engine lives in ``geom/marching_cubes.py``
(``geom/marching_squares.py`` for DIM=2 plotfiles).  A 3-D hierarchy of
more than one level whose finest union bbox wastes >4x its cells, or any
such hierarchy with ``surface_is_large=1``, takes the clustered path
(``extract_isosurface_sparse``; JAX :71-74): ``surface_is_large`` is the
reference's disk-staged memory valve (isosurface.cpp:1919-1998), and the
clustered path is the valve here.  ``build_distance_function=1`` also
writes the signed distance to the surface on every level (``geom/sdf.py``,
dense 3-D path only).

``ndevices=N`` (JAX :75-80, :93-99): the dense path extracts over N
deep-halo windows (``parallel/dense_shard.py``), each emitting the
triangles (DIM=2: the segments, ``extract_isolines_windows``) of the dual
cells its shard owns, merged by global node key into the one-device run's
MEF; the clustered path deals its clusters over N shards.  With
``build_distance_function=1`` each shard computes the distance on the
cells it owns, the sweeps walking every direction's planes across the
shards in the one-device order (``tools/build_distance.distance_sharded``
over ``geom/sdf.distance_shards``).
"""
from __future__ import annotations

import time

import torch

from .. import config
from ..amr.cluster import clustered
from ..amr.dense import DenseAmrState
from ..geom.marching_cubes import (check_engine, extract_isosurface,
                                   extract_isosurface_sparse,
                                   extract_isosurface_windows, surface_area)
from ..geom.marching_squares import (extract_isolines,
                                     extract_isolines_windows)
from ..geom.mef_tools import assemble_polylines
from ..io.mef import write_mef, write_mef_tecplot
from ..io.xdmf import write_xdmf
from ..native import savetxt_fast
from ..parallel.cluster_shard import cluster_mesh
from ..parallel.dense_shard import (ISO_HALO, ShardedDenseState,
                                    mesh_from_pp)
from ..parmparse import ParmParse
from ..session import (dense_state, get_session, load_state, stage_submit_io,
                       stage_writes, var_names)
from .build_distance import distance_sharded, distance_state
from .grad import refuse_unported


def main(args: dict) -> None:
    """CLI: isosurface infile= [isoCompName=temp] [isoVal=1000]
    [comps=<extra node fields>] [sComp= nComp=] [finestLevel=]
    [is_per=0 0 0] [writeSurf=1] [surfFormat=MEF|DAT|XDMF] [outfile_base=]
    [computeArea=0] [engine=enum] [rm_external_elements=1] [force_dense=0]
    [surface_is_large=0] [cluster_batch=0] [build_distance_function=0
    [dmax=<4*dx_finest>] [dist_outfile=|outfile=<infile>_dist]] [verbose=0]
    [writeLines=0 (DIM=2: the contour's polylines, <base>_lines.dat)]
    [ndevices=1 [mesh_shape=a b [c]]] [device=cuda|cpu].  The plotfile
    loads in float64 whatever dtype=."""
    pp = ParmParse(args)
    verbose = pp.query_int("verbose", 0)
    infile = pp.get_str("infile")
    iso_name = pp.query_str("isoCompName", "temp")
    iso_val = pp.query_float("isoVal", 1000.0)
    is_per = pp.query_int_list("is_per", [0, 0, 0])
    finest = pp.query_int("finestLevel", None)
    engine = pp.query_str("engine", "enum")
    device = config.get_device(pp.query_str("device", "cuda"))
    refuse_unported(pp)

    avail = var_names(args, infile)
    extras = pp.query_str_list("comps", [])
    extras = [avail[int(c)] if c.isdigit() else c for c in extras]
    if pp.contains("sComp") or pp.contains("nComp"):
        # reference-style comp-range selection (isosurface.cpp sComp/nComp)
        s = pp.query_int("sComp", 0)
        n = pp.query_int("nComp", 1)
        extras = extras + [v for v in avail[s: s + n]
                           if v not in extras]
    if not pp.query_bool("rm_external_elements", True):
        print("isosurface: rm_external_elements=0 ignored — the canonical "
              "per-edge engine never emits duplicate/overlap elements "
              "(the reference's per-box g1box filter has no analog here)")

    t0 = time.perf_counter()
    load = [iso_name] + [n for n in extras if n != iso_name]
    src = load_state(args, infile, names=load, max_level=finest,
                     is_periodic=[bool(p) for p in is_per],
                     dtype=torch.float64, device=device)
    meta = src.meta
    fin = meta.n_levels - 1
    ndev = pp.query_int("ndevices", 1)
    sd = None
    sparse = not meta.ndim2 and clustered(
        meta, pp, [fin], force=pp.query_bool("surface_is_large", False))
    label = f"{meta.time:g}"
    if sparse:
        print("isosurface: sparse refinement detected -> clustered path")
        base = DenseAmrState.coarse_only(meta, src.names, src.fabs, device,
                                         torch.float64)
        t1 = time.perf_counter()
        mef = extract_isosurface_sparse(
            base, src.fabs[fin], iso_name, iso_val, extras, label=label,
            mesh=cluster_mesh(ndev, device) if ndev > 1 else None)
        del base
    elif ndev > 1:
        check_engine(engine)
        # the windows hold the loaded comps only, cut on the cards from
        # a sharded output
        sd = ShardedDenseState(meta, load, src.window_source,
                               mesh_from_pp(pp, ndev, device), ISO_HALO,
                               torch.float64)
        t1 = time.perf_counter()
        if meta.ndim2:
            mef = extract_isolines_windows(sd, iso_name, iso_val, extras,
                                           label=label)
        else:
            mef = extract_isosurface_windows(sd, iso_name, iso_val, extras,
                                             label=label)
    else:
        ds = dense_state(args, src, device, torch.float64, load)
        t1 = time.perf_counter()
        if meta.ndim2:
            # DIM=2 plotfile: marching squares -> polyline contour MEF
            mef = extract_isolines(ds, iso_name, iso_val, extras,
                                   label=label)
        else:
            # a pipeline stage with write=0 keeps the surface on the card:
            # a downstream stream stage copies only the seed xyz columns
            defer = (get_session(args) is not None and not stage_writes(args)
                     and engine == "enum")
            mef = extract_isosurface(ds, iso_name, iso_val, extras,
                                     label=label, classify=engine,
                                     defer=defer)
    t2 = time.perf_counter()
    base = pp.query_str("outfile_base", f"{infile}_{iso_name}_{iso_val:g}")
    sess = get_session(args)
    if sess is not None:
        # later stages (stream isoFile=, the MEF tools) resolve these names
        # in the session before reading a file
        sess.put_surface(base + ".mef", mef)
        sess.put_surface(base + ".dat", mef)
    if pp.query_bool("writeSurf", True) and stage_writes(args):
        # the surface is on the host here (defer only with write=0): the
        # file writes may go to the write-back thread
        fmt = pp.query_str("surfFormat", "MEF").upper()
        if fmt == "MEF":
            stage_submit_io(args, base + ".mef",
                            lambda: write_mef(base + ".mef", mef))
            print(f"wrote {base}.mef  ({mef.n_nodes} nodes, "
                  f"{mef.n_elts} elements)")
        elif fmt == "XDMF":
            write_xdmf(base, mef, iso_name, iso_val, meta.time)
            print(f"wrote {base}.xmf/.mesh")
        else:
            stage_submit_io(args, base + ".dat",
                            lambda: write_mef_tecplot(base + ".dat", mef))
            print(f"wrote {base}.dat")
    if pp.query_bool("computeArea", False):
        m = mef.to_mef() if hasattr(mef, "to_mef") else mef
        print(f"Total area of surface: {surface_area(m):.10g}")
    if pp.query_bool("build_distance_function", False):
        # in-run signed-distance plotfile (isosurface.cpp:1595-1654 per-box
        # make_level_set3 + :1732-1748 WriteMultiLevelPlotfile), negative
        # where the field < isoVal (isosurface.cpp:1644)
        if meta.ndim2:
            raise ValueError("build_distance_function requires DIM=3")
        if sparse:
            raise ValueError(
                "build_distance_function is not supported on the sparse "
                "clustered path yet; pass force_dense=1 to accept the "
                "union-bbox footprint")
        dmax = pp.query_float("dmax", 4.0 * meta.geoms[fin].dx[0])
        tri = mef.positions()[mef.elements]
        # the reference names the distance plotfile with `outfile`
        # (isosurface.cpp:1734); dist_outfile is the explicit alias
        dist_file = pp.query_str(
            "dist_outfile", pp.query_str("outfile", infile + "_dist"))
        if sd is not None:
            distance_sharded(sd, tri, dmax, iso_name, iso_val).to_plotfile(
                dist_file)
        else:
            distance_state(ds, tri, dmax, iso_name, iso_val).to_plotfile(
                dist_file)
        print(f"wrote {dist_file}")
    if verbose:
        print(f"isosurface: read {t1 - t0:.3f} s, extract {t2 - t1:.3f} s, "
              f"write {time.perf_counter() - t2:.3f} s")
    if meta.ndim2 and pp.query_bool("writeLines", False):
        # MakeCLines polyline assembly (isosurface.cpp:1159-1271)
        chains = assemble_polylines(mef)
        with open(base + "_lines.dat", "w") as f:
            f.write("VARIABLES = " + " ".join(mef.names) + "\n")
            for ci, chain in enumerate(chains):
                f.write(f'ZONE T="line{ci}" I={len(chain)} '
                        "DATAPACKING=POINT\n")
                savetxt_fast(f, mef.nodes[chain], fmt="%.9g")
        print(f"wrote {base}_lines.dat ({len(chains)} polylines)")
