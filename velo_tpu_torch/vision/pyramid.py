"""Image pyramid, Scharr gradients and bilinear sampling
(port of ``velo_tpu/vision/pyramid.py:14-83``).

Images are float32 (H, W) in [0, 1]; pyramids are tuples of levels.  Edge
clamping is ``F.pad(mode="replicate")`` on a 4-D view.  The reference's
selection-matmul and window samplers are TPU layouts and have no port.
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
