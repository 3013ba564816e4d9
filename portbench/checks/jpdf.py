"""``jpdf``: a joint PDF in gnuplot form, against the reference's
binning of the same cells."""
from __future__ import annotations

from typing import Dict

import numpy as np

from portbench.checks import gap
from portbench.outputs import read_table
from portbench.reference import flame as rf


def program(spec: dict, cfg: dict) -> np.ndarray:
    t = read_table(spec["file"])
    nb = int(spec["nbins"])
    if t.shape != (nb * nb, 3):
        raise ValueError(f"{spec['file']}: {t.shape} rows, not {nb * nb} x 3")
    return t[:, 2].reshape(nb, nb)


def reference(spec: dict, st) -> np.ndarray:
    return rf.joint_pdf(st, spec["vars"][0], spec["vars"][1],
                        int(spec["nbins"]), spec["bounds"][0],
                        spec["bounds"][1])


def numbers(p, r, st) -> Dict[str, float]:
    """``jpdf_gap``: the widest gap of the PDF as a share of its peak."""
    return {"jpdf_gap": gap(p, r)}
