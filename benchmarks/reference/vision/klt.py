"""Pyramidal Lucas-Kanade tracking, inverse-compositional
(port of ``velo_tpu/vision/klt.py``).

All K features are tracked at once.  Per pyramid level, coarse to fine, a
fixed number of Gauss-Newton steps runs on (K, P) bilinear patches:

  template = patch of the previous image at the feature (fixed per level)
  grads    = Scharr gradients of the previous level (fixed, so the 2x2
             normal matrix and its inverse are computed once per level)
  iterate:   e = sample(cur, pos) - template; d = G^-1 sum(grad*e); pos -= d

``klt_impl``: "auto" and "gather" sample patches with flat gathers, as the
reference does off the TPU; "pallas" runs level 0 through the
``kernels.klt_l0`` kernel when the image fits its blocks (coarser levels,
and images that do not fit, take the gather path); "matmul" samples by
selection products (``klt_dtype`` operands); "window" samples each level's
windows once and then iterates inside them, so a track that reaches the
window's edge freezes there (and ignores ``klt_iters_fb``, as the
reference does).  The selection products are plain matrix products, as
the reference leaves them to XLA.
A forward-backward consistency check gates tracking failures.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmarks.reference import fp
from benchmarks.reference.kernels import klt_l0
from benchmarks.reference.vision import pyramid as pyr

_IMPLS = ("auto", "gather", "pallas", "matmul", "window")


class TrackResult(NamedTuple):
    uv: torch.Tensor  # (K, 2) tracked positions in the current image
    ok: torch.Tensor  # (K,) tracked successfully (converged, in-bounds, fb)
    fb_err: torch.Tensor  # (K,) forward-backward error in px


def check_impl(cfg) -> None:
    """Raise ValueError for an unknown ``klt_impl``."""
    if cfg.klt_impl not in _IMPLS:
        raise ValueError(f"unknown klt_impl {cfg.klt_impl!r}")


def _dtype(cfg):
    """The selection products' operand type."""
    return torch.bfloat16 if cfg.klt_dtype == "bf16" else None


def _sample_patches(img, centers, cfg):
    """(K, P) bilinear patches + per-feature in-bounds flag: selection
    products with ``klt_impl="matmul"``, else flat gathers."""
    if cfg.klt_impl == "matmul":
        p, inb = pyr.bilinear_patches_matmul(img, centers, cfg.klt_halfwin,
                                             dtype=_dtype(cfg))
        return p.reshape(centers.shape[0], -1), inb
    offs = pyr.patch_offsets(cfg.klt_halfwin, device=img.device)
    vals, inb = pyr.bilinear_sample(img, centers[:, None, :] + offs[None])
    return vals, torch.all(inb, dim=1)


def _in_image(uv, halfwin, H, W):
    """The patch around each (x, y) lies inside the image (the matmul
    sampler's rule)."""
    S = 2 * halfwin + 1
    x0 = torch.floor(uv[:, 0]).to(torch.int32) - halfwin
    y0 = torch.floor(uv[:, 1]).to(torch.int32) - halfwin
    return (x0 >= 0) & (y0 >= 0) & (x0 + S < W) & (y0 + S < H)


def _inverse_normal(gx, gy, ok):
    """The 2x2 normal matrix of the template gradients, inverted per
    feature -> ((inv00, inv01, inv11), ok and not degenerate)."""
    gxx = fp.sum(gx * gx, dim=1)
    gxy = fp.sum(gx * gy, dim=1)
    gyy = fp.sum(gy * gy, dim=1)
    det = gxx * gyy - gxy * gxy
    ok = ok & (det > 1e-9)
    safe_det = torch.where(det > 1e-9, det, 1.0)
    return (gyy / safe_det, -gxy / safe_det, gxx / safe_det), ok


def _in_bounds(uv, H, W):
    return ((uv[:, 0] >= 1) & (uv[:, 0] <= W - 2)
            & (uv[:, 1] >= 1) & (uv[:, 1] <= H - 2))


def _track_level_window(img_prev, gx_prev, gy_prev, img_cur, uv_prev,
                        uv_cur, cfg):
    """Local-window IC-LK level: the template, its gradients and the
    current image are cut into (K, Sw, Sw) windows once (Sw = S + 1 +
    2 * ``klt_win_slack``); every Gauss-Newton step samples its patch
    inside them.  A step that would leave its window does not apply, so
    a track that reaches the edge freezes there.  Runs ``klt_iters``
    steps whatever the caller asks, as the reference does."""
    h = cfg.klt_halfwin
    slack = cfg.klt_win_slack
    Sw = 2 * h + 2 + 2 * slack
    H, W = img_cur.shape
    K = uv_prev.shape[0]
    dtype = _dtype(cfg)

    ptl = torch.floor(uv_prev).to(torch.int32) - (h + slack)  # (K, 2)
    pwin = pyr.integer_windows(torch.stack([img_prev, gx_prev, gy_prev]),
                               ptl, Sw, dtype=dtype)
    luv_prev = uv_prev - ptl.to(torch.float32)
    tmpl, gx, gy = (pyr.bilinear_patches_local(w, luv_prev, h)[0]
                    .reshape(K, -1) for w in pwin)
    inv, ok = _inverse_normal(gx, gy, _in_image(uv_prev, h, H, W))
    inv00, inv01, inv11 = inv

    ctl = torch.floor(uv_cur).to(torch.int32) - (h + slack)
    cwin = pyr.integer_windows(img_cur[None], ctl, Sw, dtype=dtype)[0]
    ctl_f = ctl.to(torch.float32)
    uv = uv_cur
    for _ in range(cfg.klt_iters):
        cur, c_inw = pyr.bilinear_patches_local(cwin, uv - ctl_f, h)
        e = cur.reshape(K, -1) - tmpl
        bx = fp.sum(gx * e, dim=1)
        by = fp.sum(gy * e, dim=1)
        d = torch.stack([inv00 * bx + inv01 * by,
                         inv01 * bx + inv11 * by], dim=-1)
        step_ok = ok & c_inw & _in_image(uv, h, H, W)
        uv = uv - torch.where(step_ok[:, None], d, 0.0)
    return uv, ok & _in_bounds(uv, H, W)


def _track_level(img_prev, gx_prev, gy_prev, img_cur, uv_prev, uv_cur,
                 cfg, iters=None):
    """One pyramid level of IC-LK for all features -> (uv_cur, ok)."""
    check_impl(cfg)
    if iters is None:
        iters = cfg.klt_iters
    if cfg.klt_impl == "pallas":
        H, W = img_cur.shape
        if (H, W) == tuple(img_prev.shape) and klt_l0.fits(H, W) \
                and (H, W) == (cfg.height, cfg.width):
            return klt_l0.track_level0(img_prev, img_cur,
                                       uv_prev.contiguous(),
                                       uv_cur.contiguous(), cfg, iters)
    if cfg.klt_impl == "window":
        return _track_level_window(img_prev, gx_prev, gy_prev, img_cur,
                                   uv_prev, uv_cur, cfg)
    if cfg.klt_impl == "matmul":
        # The template and its gradients share the selection weights.
        stack, t_in = pyr.bilinear_patches_matmul_multi(
            torch.stack([img_prev, gx_prev, gy_prev]), uv_prev,
            cfg.klt_halfwin, dtype=_dtype(cfg))
        tmpl, gx, gy = (x.reshape(uv_prev.shape[0], -1) for x in stack)
    else:
        tmpl, t_in = _sample_patches(img_prev, uv_prev, cfg)
        gx, _ = _sample_patches(gx_prev, uv_prev, cfg)
        gy, _ = _sample_patches(gy_prev, uv_prev, cfg)
    (inv00, inv01, inv11), ok = _inverse_normal(gx, gy, t_in)

    uv = uv_cur
    for _ in range(iters):
        cur, c_in = _sample_patches(img_cur, uv, cfg)
        e = cur - tmpl
        bx = fp.sum(gx * e, dim=1)
        by = fp.sum(gy * e, dim=1)
        dx = inv00 * bx + inv01 * by
        dy = inv01 * bx + inv11 * by
        d = torch.stack([dx, dy], dim=-1)
        # Inverse-compositional update: move against the error.
        uv = uv - torch.where((ok & c_in)[:, None], d, 0.0)
    H, W = img_cur.shape
    return uv, ok & _in_bounds(uv, H, W)


def track_pyramid(prev_pyr, cur_pyr, prev_grads, uv0, valid, cfg,
                  uv_init=None, n_levels=None, iters=None):
    """Track features from the previous to the current pyramid.

    Initial guess: ``uv_init`` if given, else the template position.
    ``n_levels`` restricts the pass to the finest n levels.  Only the finest
    level's validity gates (a coarse level that loses a feature passes its
    position through, as OpenCV does).
    """
    levels = cfg.pyr_levels if n_levels is None else n_levels
    scale = 2.0 ** (levels - 1)
    uv = (uv0 if uv_init is None else uv_init) / scale
    ok = valid
    for lv in range(levels - 1, -1, -1):
        gx, gy = prev_grads[lv]
        uv, lok = _track_level(prev_pyr[lv], gx, gy, cur_pyr[lv],
                               uv0 / (2.0 ** lv), uv, cfg, iters=iters)
        if lv == 0:
            ok = ok & lok
        else:
            uv = uv * 2.0
    return uv, ok


def track(prev_pyr, cur_pyr, prev_grads, cur_grads, uv0, valid,
          cfg) -> TrackResult:
    """Forward track + backward consistency check.

    The backward pass runs the finest ``fb_levels`` levels from the expected
    landing position ``uv0``; ``fb_levels >= pyr_levels`` runs the classic
    uninitialized full-pyramid check.
    """
    uv_f, ok_f = track_pyramid(prev_pyr, cur_pyr, prev_grads, uv0, valid,
                               cfg)
    full = cfg.fb_levels >= cfg.pyr_levels
    uv_b, ok_b = track_pyramid(cur_pyr, prev_pyr, cur_grads, uv_f,
                               valid & ok_f, cfg,
                               uv_init=None if full else uv0,
                               n_levels=min(cfg.fb_levels, cfg.pyr_levels),
                               iters=cfg.klt_iters_fb)
    fb = fp.norm(uv_b - uv0)
    ok = valid & ok_f & ok_b & (fb < cfg.fb_max_err)
    if cfg.max_track_residual < 1e8:
        # Absolute appearance gate: mean |I_cur(patch at uv_f) -
        # I_prev(patch at uv0)|.
        tmpl, _ = _sample_patches(prev_pyr[0], uv0, cfg)
        cur, _ = _sample_patches(cur_pyr[0], uv_f, cfg)
        resid = fp.div(fp.sum(torch.abs(cur - tmpl), dim=1), tmpl.shape[1])
        ok = ok & (resid < cfg.max_track_residual)
    return TrackResult(uv=uv_f, ok=ok, fb_err=fb)


def frame_gradients(img_pyr):
    """Per-level Scharr gradients of one pyramid (reused fwd/bwd)."""
    return tuple(pyr.scharr_gradients(im) for im in img_pyr)
