"""``mef``: an isosurface's MEF, against the reference's marching cubes
on the same field."""
from __future__ import annotations

from typing import Dict

import numpy as np

from portbench.checks import gap
from portbench.outputs import mef_area, read_mef
from portbench.reference import flame as rf


def program(spec: dict, cfg: dict) -> dict:
    m = read_mef(spec["file"])
    want = ["X", "Y", "Z", spec["iso"]] + list(spec["extras"])
    if m["names"] != want:
        raise ValueError(f"{spec['file']}: fields {m['names']}, not {want}")
    cols = [0, 1, 2] + list(range(4, len(want)))
    return {"nodes": m["nodes"][:, cols], "area": mef_area(m)}


def reference(spec: dict, st) -> dict:
    out = rf.isosurface(st, spec["iso"], float(spec["iso_val"]),
                        spec["extras"])
    return {"nodes": out["nodes"], "area": out["area"]}


def numbers(p: dict, r: dict, st) -> Dict[str, float]:
    """``mef_node_dist``: the farthest any node of one surface lies from
    the other's nearest node, in finest cells; ``mef_field_gap``: the
    widest gap of a sampled field at matched nodes, as a share of the
    field's largest magnitude; ``mef_area_gap``: the relative gap of the
    total area."""
    from scipy.spatial import cKDTree
    dx = st.h.dx(st.h.n_levels - 1)
    pn, rn = p["nodes"], r["nodes"]
    if len(pn) == 0 or len(rn) == 0:
        inf = float("inf")
        return {"mef_node_dist": inf, "mef_field_gap": inf,
                "mef_area_gap": inf}
    d_pr, i_pr = cKDTree(rn[:, :3]).query(pn[:, :3])
    d_rp, _ = cKDTree(pn[:, :3]).query(rn[:, :3])
    gaps = [gap(pn[:, c], rn[i_pr, c]) for c in range(3, pn.shape[1])]
    area = abs(p["area"] - r["area"]) / r["area"]
    return {"mef_node_dist": float(max(d_pr.max(), d_rp.max()) / dx),
            "mef_field_gap": max(gaps, default=0.0),
            "mef_area_gap": float(area) if np.isfinite(area) else float("inf")}
