"""Shi-Tomasi corners with grid bucketing (port of
``velo_tpu/vision/corners.py``).

The min-eigenvalue response of the 5x5-aggregated structure tensor is
computed densely; min-distance spacing is a fixed (grid_rows x grid_cols)
bucket grid with the best corner per bucket, so the candidate set has a
fixed size and a validity mask.  ``torch.argmax`` returns the first index
of a tie, as ``jnp.argmax`` does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from benchmarks.reference import fp
from benchmarks.reference.vision import pyramid


class Corners(NamedTuple):
    uv: torch.Tensor  # (G, 2) float pixel coords, G = grid_rows*grid_cols
    response: torch.Tensor  # (G,)
    valid: torch.Tensor  # (G,)


def _box5(img: torch.Tensor) -> torch.Tensor:
    """5x5 box filter via two separable passes (edge-clamped)."""
    p = F.pad(img[None, None], (0, 0, 2, 2), mode="replicate")[0, 0]
    v = p[:-4] + p[1:-3] + p[2:-2] + p[3:-1] + p[4:]
    p = F.pad(v[None, None], (2, 2, 0, 0), mode="replicate")[0, 0]
    return fp.div(p[:, :-4] + p[:, 1:-3] + p[:, 2:-2] + p[:, 3:-1] + p[:, 4:],
                  25.0)


def shi_tomasi_response(img: torch.Tensor) -> torch.Tensor:
    """Dense min-eigenvalue of the 5x5-aggregated structure tensor."""
    ix, iy = pyramid.scharr_gradients(img)
    sxx = _box5(ix * ix)
    syy = _box5(iy * iy)
    sxy = _box5(ix * iy)
    tr = 0.5 * (sxx + syy)
    d = sxx - syy
    det_term = fp.sqrt(torch.clamp(0.25 * (d * d) + sxy * sxy, min=0.0))
    return tr - det_term  # lambda_min


def detect(img: torch.Tensor, cfg, border: int = 8) -> Corners:
    """Best corner per grid bucket above the response threshold."""
    H, W = img.shape
    gr, gc = cfg.grid_rows, cfg.grid_cols
    resp = shi_tomasi_response(img)
    # Kill the border so KLT patches always fit.
    mask = torch.zeros((H, W), dtype=torch.bool, device=img.device)
    mask[border:H - border, border:W - border].fill_(True)  # (captures)
    resp = torch.where(mask, resp, -1.0)

    bh, bw = H // gr, W // gc
    r = resp[:gr * bh, :gc * bw].reshape(gr, bh, gc, bw).permute(0, 2, 1, 3)
    r = r.reshape(gr * gc, bh * bw)
    best = torch.argmax(r, dim=1)
    best_resp = torch.gather(r, 1, best[:, None])[:, 0]
    by = best // bw
    bx = best % bw
    cell = torch.arange(gr * gc, device=img.device)
    cy = (cell // gc) * bh + by
    cx = (cell % gc) * bw + bx
    uv = torch.stack([cx, cy], dim=-1).to(torch.float32)
    return Corners(uv=uv, response=best_resp,
                   valid=best_resp > cfg.min_corner_response)
