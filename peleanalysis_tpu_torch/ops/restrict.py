"""Fine-to-coarse restriction (amrex::average_down analog) and flux-matched
gradients on dense levels (plain PyTorch).

Counterpart of ``peleanalysis_tpu/ops/restrict.py``: a reshape-mean over
ratio blocks overlaid where the coarse level is covered, and the MLMG-style
face-flux matching of grad.cpp:178-219.  Neither has a kernel in the JAX
package; both stay plain torch ops here.

The boundary faces of the covered region are host-side metadata; they are
built once per state with numpy and kept on the device in a cache the
caller owns (``DenseAmrState.flux_face_masks``).  The block means sum their
terms in PyTorch's order, which is not always XLA's: float64 results agree
with the JAX package's to the last bit where every order sums exactly, and
within an ulp or so otherwise.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .stencil import _const


def average_down_level(meta, lmeta, x_crse: torch.Tensor, x_fine: torch.Tensor,
                       covered_crse: torch.Tensor, lev_crse: int
                       ) -> torch.Tensor:
    """The coarse dense array with its covered cells replaced by the block
    mean of their fine children.  x_crse [C, *bbox_c], x_fine [C, *bbox_f];
    the inputs are not modified."""
    r = meta.ref_ratio[lev_crse]
    bbox_c = lmeta[lev_crse].bbox
    bbox_f = lmeta[lev_crse + 1].bbox
    # fine bbox in coarse index space (ratio-aligned in AMReX hierarchies;
    # an unaligned fine extent is cropped to whole blocks)
    flo_c = [bbox_f.lo[d] // r for d in range(3)]
    fshape = x_fine.shape[1:]
    nc = [fshape[d] // r for d in range(3)]
    crop = x_fine[:, : nc[0] * r, : nc[1] * r, : nc[2] * r]
    down = crop.reshape(x_fine.shape[0], nc[0], r, nc[1], r,
                        nc[2], r).mean(dim=(2, 4, 6))
    sl = (slice(None),) + tuple(
        slice(flo_c[d] - bbox_c.lo[d], flo_c[d] - bbox_c.lo[d] + nc[d])
        for d in range(3))
    out = x_crse.clone()
    out[sl] = torch.where(covered_crse[sl[1:]][None], down, x_crse[sl])
    return out


def average_down_all(meta, lmeta, x_list: List[torch.Tensor],
                     covered_list) -> List[torch.Tensor]:
    """Fine-to-coarse sweep over the whole hierarchy."""
    out = list(x_list)
    for lev in range(meta.n_levels - 2, -1, -1):
        out[lev] = average_down_level(meta, lmeta, out[lev], out[lev + 1],
                                      covered_list[lev], lev)
    return out


def _faces_along(g: torch.Tensor, d: int, dxd: float) -> torch.Tensor:
    """Face gradients along axis d of a 1-ghost grown array [1, X+2, Y+2,
    Z+2] -> [1, ..S+1 along d.., S transverse] (faces of the bbox cells)."""
    hi = [slice(1, -1)] * 3
    lo = [slice(1, -1)] * 3
    hi[d] = slice(1, None)
    lo[d] = slice(0, -1)
    return (g[(slice(None),) + tuple(hi)]
            - g[(slice(None),) + tuple(lo)]) / _const(dxd, g)


def covered_boundary_faces(cov: np.ndarray, d: int) -> np.ndarray:
    """bool faces along d (one more than cells along d) that separate a
    covered cell from an uncovered one or from outside the bbox."""
    covp = np.concatenate([np.zeros_like(np.take(cov, [0], axis=d)), cov,
                           np.zeros_like(np.take(cov, [0], axis=d))], axis=d)
    return np.logical_xor(
        np.take(covp, range(0, covp.shape[d] - 1), axis=d),
        np.take(covp, range(1, covp.shape[d]), axis=d))


def flux_matched_gradient(meta, lmeta, grown_list, covered_list,
                          face_masks: Optional[Dict] = None):
    """Cell-centered gradients with MLMG-style flux matching: on every
    coarse face bounding the fine-covered region, the coarse face flux is
    replaced by the transverse mean of the fine face fluxes before the
    face->cell average (grad.cpp:178-219).  Away from interfaces the
    face->cell average is the centered difference.

    grown_list: per-level [1, *bbox+2] (one filled ghost ring);
    covered_list: per-level host bool [bbox] covered-by-finer masks;
    face_masks: a dict that keeps the device boundary-face masks between
    calls, keyed by (lev, d), or None to build them each call.
    Returns [lev][d] -> [1, *bbox] gradient components."""
    n_lev = meta.n_levels
    if face_masks is None:
        face_masks = {}
    out = []
    for lev in range(n_lev):
        g = grown_list[lev]
        dx = meta.geoms[lev].dx
        grads = []
        for d in range(3):
            F = _faces_along(g, d, dx[d])
            if lev + 1 < n_lev:
                bbox_c = lmeta[lev].bbox
                bbox_f = lmeta[lev + 1].bbox
                r = meta.ref_ratio[lev]
                # per-dim ratio: a promoted 2-D z axis has extent 1 (ratio 1)
                rt = [1 if bbox_f.shape[j] == 1 else r for j in range(3)]
                if rt[d] > 1:
                    gf = grown_list[lev + 1]
                    Ff = _faces_along(gf, d, meta.geoms[lev + 1].dx[d])
                    # coarse-aligned planes along d, then the transverse
                    # block mean over each ratio sub-axis
                    sl = [slice(None)] * 4
                    sl[1 + d] = slice(None, None, rt[d])
                    Fr = Ff[tuple(sl)]
                    shp, new_shape, red, pos = Fr.shape, [Fr.shape[0]], [], 1
                    for j in range(3):
                        if j == d:
                            new_shape.append(shp[1 + j])
                            pos += 1
                        else:
                            new_shape += [shp[1 + j] // rt[j], rt[j]]
                            red.append(pos + 1)
                            pos += 2
                    Fr = Fr.reshape(new_shape).mean(dim=tuple(red))
                    # region of coarse faces over the fine bbox
                    flo = [bbox_f.lo[j] // rt[j] - bbox_c.lo[j]
                           for j in range(3)]
                    nc = [bbox_f.shape[j] // rt[j] for j in range(3)]
                    reg = [slice(flo[j], flo[j] + nc[j]) for j in range(3)]
                    reg[d] = slice(flo[d], flo[d] + nc[d] + 1)
                    reg = (slice(None),) + tuple(reg)
                    if (lev, d) not in face_masks:
                        bnd = covered_boundary_faces(
                            np.asarray(covered_list[lev]), d)
                        face_masks[(lev, d)] = torch.from_numpy(
                            np.ascontiguousarray(bnd[reg[1:]])).to(F.device)
                    F[reg] = torch.where(face_masks[(lev, d)][None], Fr,
                                         F[reg])
            lo = [slice(None)] * 4
            hi = [slice(None)] * 4
            lo[1 + d] = slice(0, -1)
            hi[1 + d] = slice(1, None)
            grads.append(0.5 * (F[tuple(lo)] + F[tuple(hi)]))
        out.append(grads)
    return out
