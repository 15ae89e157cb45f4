"""Image pyramid, Scharr gradients and bilinear sampling
(port of ``velo_tpu/vision/pyramid.py``).

Images are float32 (H, W) in [0, 1]; pyramids are tuples of levels.  Edge
clamping is ``F.pad(mode="replicate")`` on a 4-D view.  Besides the flat
gather (:func:`bilinear_sample`), the reference's selection-matmul
samplers: bilinear weights as two-diagonal selection matrices, patches as
two plain matrix products (``klt_impl="matmul"``), and integer windows
sampled once per level (``klt_impl="window"``).  With ``dtype=bfloat16``
the selection operands are rounded to bfloat16, as the reference rounds
them, and the products sum in float32 (its ``preferred_element_type``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad(img: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Edge-replicate padding of an (H, W) image."""
    return F.pad(img[None, None], (cols, cols, rows, rows),
                 mode="replicate")[0, 0]


def blur3(img: torch.Tensor) -> torch.Tensor:
    """Separable [1 2 1]/4 binomial blur (edge-clamped)."""
    p = _pad(img, 0, 1)
    h = (p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]) * 0.25
    p2 = _pad(h, 1, 0)
    return (p2[:-2] + 2.0 * p2[1:-1] + p2[2:]) * 0.25


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """Antialiased 2x downsample (blur then stride)."""
    return blur3(img)[::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, levels: int):
    """Tuple of (H/2^l, W/2^l) images, level 0 = full resolution."""
    out = [img]
    for _ in range(levels - 1):
        out.append(downsample2(out[-1]))
    return tuple(out)


def scharr_gradients(img: torch.Tensor):
    """Scharr 3x3 x/y gradients (edge-clamped), returned as (Ix, Iy)."""
    p = _pad(img, 1, 1)
    gx = (3.0 * (p[:-2, 2:] - p[:-2, :-2])
          + 10.0 * (p[1:-1, 2:] - p[1:-1, :-2])
          + 3.0 * (p[2:, 2:] - p[2:, :-2])) / 32.0
    gy = (3.0 * (p[2:, :-2] - p[:-2, :-2])
          + 10.0 * (p[2:, 1:-1] - p[:-2, 1:-1])
          + 3.0 * (p[2:, 2:] - p[:-2, 2:])) / 32.0
    return gx, gy


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor):
    """Sample img at float (..., 2) pixel coords (x, y), border-clamped.

    Returns (values (...,), in_bounds (...,)): out-of-bounds samples are
    clamped but flagged.
    """
    H, W = img.shape
    x = xy[..., 0]
    y = xy[..., 1]
    inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0.to(x.dtype)
    fy = y - y0.to(y.dtype)
    flat = img.reshape(-1)
    i00 = flat[y0 * W + x0]
    i01 = flat[y0 * W + x0 + 1]
    i10 = flat[(y0 + 1) * W + x0]
    i11 = flat[(y0 + 1) * W + x0 + 1]
    top = i00 * (1 - fx) + i01 * fx
    bot = i10 * (1 - fx) + i11 * fx
    return top * (1 - fy) + bot * fy, inb


def patch_offsets(halfwin: int, device=None) -> torch.Tensor:
    """((2h+1)^2, 2) integer offsets of a square patch, (x, y) order."""
    r = torch.arange(-halfwin, halfwin + 1, dtype=torch.float32,
                     device=device)
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)


def _mm(eq: str, a: torch.Tensor, b: torch.Tensor, dtype=None):
    """``einsum(eq, a, b)`` in float32, the operands first rounded to
    ``dtype`` when one is given (the products of two bfloat16 values are
    exact in float32)."""
    if dtype is not None:
        a = a.to(dtype).to(torch.float32)
        b = b.to(dtype).to(torch.float32)
    return torch.einsum(eq, a, b)


def _selection(centers, halfwin, H, W):
    """Two-diagonal bilinear selection weights of (K, 2) centers: wcol
    (W, K, S), wrow (K, S, H), and the patch-inside-image flag."""
    S = 2 * halfwin + 1
    dev = centers.device
    x, y = centers[:, 0], centers[:, 1]
    x0 = torch.floor(x).to(torch.int32) - halfwin
    y0 = torch.floor(y).to(torch.int32) - halfwin
    fx = x - torch.floor(x)
    fy = y - torch.floor(y)
    inb = (x0 >= 0) & (y0 >= 0) & (x0 + S < W) & (y0 + S < H)
    ar = torch.arange(S, dtype=torch.int32, device=dev)
    src = torch.arange(W, dtype=torch.int32, device=dev)[:, None, None]
    tgt = x0[None, :, None] + ar[None, None, :]
    wcol = ((src == tgt) * (1.0 - fx)[None, :, None]
            + (src == tgt + 1) * fx[None, :, None])  # (W, K, S)
    rsrc = torch.arange(H, dtype=torch.int32, device=dev)[None, None, :]
    rtgt = y0[:, None, None] + ar[None, :, None]
    wrow = ((rsrc == rtgt) * (1.0 - fy)[:, None, None]
            + (rsrc == rtgt + 1) * fy[:, None, None])  # (K, S, H)
    return wcol, wrow, inb


def bilinear_patches_matmul(img: torch.Tensor, centers: torch.Tensor,
                            halfwin: int, dtype=None):
    """Bilinear (K, S, S) patches around float (x, y) centers by two
    selection products, ``img @ wcol`` then ``wrow @ strips``.  Returns
    (patches float32, in_bounds (K,)): rows and columns outside the image
    select nothing, and ``in_bounds`` flags the features they touch."""
    H, W = img.shape
    wcol, wrow, inb = _selection(centers, halfwin, H, W)
    strips = _mm("hw,wks->hks", img, wcol, dtype)  # (H, K, S)
    return _mm("krh,hkc->krc", wrow, strips, dtype), inb


def bilinear_patches_matmul_multi(imgs: torch.Tensor, centers: torch.Tensor,
                                  halfwin: int, dtype=None):
    """(C, K, S, S) patches of a (C, H, W) channel stack that share the
    selection weights (an image and its two gradients), one product
    pair for all channels."""
    _, H, W = imgs.shape
    wcol, wrow, inb = _selection(centers, halfwin, H, W)
    strips = _mm("chw,wks->chks", imgs, wcol, dtype)
    return _mm("krh,chks->ckrs", wrow, strips, dtype), inb


def integer_windows(imgs: torch.Tensor, topleft: torch.Tensor, size: int,
                    dtype=None) -> torch.Tensor:
    """(C, K, size, size) integer-anchored windows of a (C, H, W) stack at
    (K, 2) int32 (x0, y0) corners, by selection products; rows and
    columns outside the image read zero."""
    _, H, W = imgs.shape
    dev = imgs.device
    ar = torch.arange(size, dtype=torch.int32, device=dev)
    src = torch.arange(W, dtype=torch.int32, device=dev)[:, None, None]
    wcol = (src == topleft[None, :, 0, None] + ar[None, None]).to(
        imgs.dtype)  # (W, K, size)
    rsrc = torch.arange(H, dtype=torch.int32, device=dev)[None, None, :]
    wrow = (rsrc == topleft[:, 1][:, None, None] + ar[None, :, None]).to(
        imgs.dtype)  # (K, size, H)
    strips = _mm("chw,wks->chks", imgs, wcol, dtype)
    return _mm("krh,chks->ckrs", wrow, strips, dtype)


def bilinear_patches_local(wins: torch.Tensor, luv: torch.Tensor,
                           halfwin: int):
    """Bilinear (K, S, S) patches from (K, Sw, Sw) per-track windows at
    (K, 2) window-local centers, two small products per track.  Returns
    (patches, inside-the-window flag)."""
    _, Sw, _ = wins.shape
    S = 2 * halfwin + 1
    dev = wins.device
    x, y = luv[:, 0], luv[:, 1]
    x0 = torch.floor(x).to(torch.int32) - halfwin
    y0 = torch.floor(y).to(torch.int32) - halfwin
    fx = x - torch.floor(x)
    fy = y - torch.floor(y)
    inw = (x0 >= 0) & (y0 >= 0) & (x0 + S < Sw) & (y0 + S < Sw)
    ar = torch.arange(S, dtype=torch.int32, device=dev)
    sw = torch.arange(Sw, dtype=torch.int32, device=dev)
    tgt = x0[:, None, None] + ar[None, None, :]
    src = sw[None, :, None]
    wcol = ((src == tgt) * (1.0 - fx)[:, None, None]
            + (src == tgt + 1) * fx[:, None, None])  # (K, Sw, S)
    rtgt = y0[:, None, None] + ar[None, :, None]
    rsrc = sw[None, None, :]
    wrow = ((rsrc == rtgt) * (1.0 - fy)[:, None, None]
            + (rsrc == rtgt + 1) * fy[:, None, None])  # (K, S, Sw)
    rows = torch.einsum("ksw,kwv->ksv", wrow, wins)  # (K, S, Sw)
    return torch.einsum("ksv,kvc->ksc", rows, wcol), inw
