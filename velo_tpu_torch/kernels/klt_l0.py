"""Level-0 inverse-compositional Lucas-Kanade for all K tracks.

Port of ``velo_tpu/pallas/klt_l0.py``.  For every track: a 15x15 bilinear
template and Scharr-gradient patches of the previous image at ``uv_prev``,
the inverse 2x2 normal matrix, then ``iters`` Gauss-Newton steps on the
current image starting at ``uv_cur``.  The TPU kernel works on one
(32, 384) previous-image block and one (48, 384) current-image block per
track, with origins rounded to (8, 128) tiles; those origins decide where a
track freezes and whether it is ``ok``, so they are reproduced as
arithmetic here:

    pry = clip((floor(y_prev) - h - 2) // 8, 0, (H-32)//8) * 8
    prx = clip((floor(x_prev) - h - 2) // 128, 0, W/128 - 3) * 128
    cry = clip((floor(y_cur) - h - 12) // 8, 0, (H-48)//8) * 8
    crx = clip(floor(x_cur) // 128 - 1, 0, W/128 - 3) * 128

(a NaN coordinate gives origin 0).  A NaN position reads -1e6 before
anything else, so a NaN track returns -1e6.  A track is ``ok`` when its
template support lies >= 1 px inside the image (then the in-block Scharr
gradients equal the whole image's) and det > 1e-9; a step applies only
while the current patch lies inside both the image and the current block
fixed from the initial ``uv_cur``; the result is ``ok`` only inside
[1, W-2] x [1, H-2].

``track_level0`` launches the CUDA kernel ``csrc/klt_l0.cu`` for tensors on
a GPU and runs the plain PyTorch version for tensors on the CPU, never one
in place of the other.  Both fix the arithmetic: bilinear rows first, then
columns; every 225-sum left to right along each patch row, then over rows
0..14 in order; separate IEEE products and sums.  So on the card the two
agree to the bit.

The card path is the custom operator ``velo_tpu_torch::klt_l0`` on a
leading batch axis.  Under ``torch.func.vmap`` (the batched odometry step,
``pipeline/batch.py``) its batching rule merges the vmapped axis into that
one and launches once for all sequences; on the CPU ``vmap`` traces the
plain version's operations.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from velo_tpu_torch.kernels import _build
from velo_tpu_torch.vision import pyramid as pyr

PB_R = 32  # previous-image block rows
CB_R = 48  # current-image block rows
BW = 384  # block width
HALFWIN = 7  # the block geometry holds 15x15 patches (16 support rows)
_DET_MIN = 1e-9
_NAN_POS = -1e6
_SAT = 2.0 ** 30  # float -> int saturation of the address arithmetic

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_KERNEL = _build.Entry(
    "klt_l0", "klt_l0_launch",
    [_p, _ll, _p, _ll, _i, _i, _p, _ll, _p, _ll, _i, _i, _i, _p, _p],
    plain="track_level0_reference")


def fits(H: int, W: int) -> bool:
    """Whether an (H, W) image fits the block geometry."""
    return W % 128 == 0 and W >= BW and H >= CB_R and H % 8 == 0


def _check(prev, cur, uv_prev, uv_cur, cfg, iters):
    if not (prev.dtype == cur.dtype == uv_prev.dtype == uv_cur.dtype
            == torch.float32):
        raise TypeError("images and positions must be float32")
    if not (prev.device == cur.device == uv_prev.device == uv_cur.device):
        raise ValueError("images and positions must share a device")
    if prev.ndim != 2 or prev.shape != cur.shape:
        raise ValueError(f"bad image shapes {tuple(prev.shape)}, "
                         f"{tuple(cur.shape)}")
    K = uv_prev.shape[0]
    if uv_prev.shape != (K, 2) or uv_cur.shape != (K, 2) or K < 1:
        raise ValueError(f"bad position shapes {tuple(uv_prev.shape)}, "
                         f"{tuple(uv_cur.shape)}")
    H, W = prev.shape
    if not fits(H, W):
        raise ValueError(f"image {H}x{W} does not fit the level-0 blocks "
                         "(W % 128 == 0, W >= 384, H >= 48, H % 8 == 0)")
    if cfg.klt_halfwin != HALFWIN:
        raise ValueError(f"klt_halfwin={cfg.klt_halfwin}: the level-0 "
                         f"blocks hold halfwin {HALFWIN} only")
    if iters < 0:
        raise ValueError(f"iters={iters} < 0")
    for t in (prev, cur, uv_prev, uv_cur):
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def _floor_int(v: torch.Tensor) -> torch.Tensor:
    """nan_to_num(floor(v), nan=0) as int64, saturated at +-2^30."""
    f = torch.nan_to_num(torch.floor(v), nan=0.0)
    return torch.clamp(f, -_SAT, _SAT).to(torch.int64)


def _origins(uv_prev, uv_cur, H, W, h):
    fp_ = _floor_int(uv_prev)
    fc = _floor_int(uv_cur)
    top = W // 128 - BW // 128
    pry = torch.clamp(torch.div(fp_[:, 1] - h - 2, 8, rounding_mode="floor"),
                      0, (H - PB_R) // 8) * 8
    prx = torch.clamp(torch.div(fp_[:, 0] - h - 2, 128,
                                rounding_mode="floor"), 0, top) * 128
    cry = torch.clamp(torch.div(fc[:, 1] - h - 12, 8, rounding_mode="floor"),
                      0, (H - CB_R) // 8) * 8
    crx = torch.clamp(torch.div(fc[:, 0], 128, rounding_mode="floor") - 1,
                      0, top) * 128
    return pry, prx, cry, crx


def _patch15(img, r0, c0, fx, fy):
    """(K, 15, 15) bilinear patches with top-left support pixel (r0, c0):
    rows lerped first, then columns.  Addresses are clamped into the image
    (only tracks whose support lies inside read the values)."""
    H, W = img.shape
    ar = torch.arange(16, device=img.device)
    rows = torch.clamp(r0[:, None] + ar, 0, H - 1)
    cols = torch.clamp(c0[:, None] + ar, 0, W - 1)
    win = img[rows[:, :, None], cols[:, None, :]]  # (K, 16, 16)
    fy = fy[:, None, None]
    fx = fx[:, None, None]
    r15 = win[:, :15, :] * (1.0 - fy) + win[:, 1:, :] * fy
    return r15[:, :, :15] * (1.0 - fx) + r15[:, :, 1:] * fx


def _sum225(p: torch.Tensor) -> torch.Tensor:
    """(K, 15, 15) -> (K,): each row left to right, then rows in order."""
    row = p[:, :, 0]
    for j in range(1, p.shape[2]):
        row = row + p[:, :, j]
    tot = row[:, 0]
    for i in range(1, p.shape[1]):
        tot = tot + row[:, i]
    return tot


class _Template(NamedTuple):
    """What the previous image fixes for each track."""
    tmpl: torch.Tensor  # (K, 15, 15) template patch
    gx: torch.Tensor  # (K, 15, 15) Scharr gradient patches
    gy: torch.Tensor
    inv: tuple  # (inv00, inv01, inv11) of the 2x2 normal matrix
    t_in: torch.Tensor  # (K,) template support >= 1 px inside the image
    ok: torch.Tensor  # (K,) t_in & det > 1e-9
    r0: torch.Tensor  # (K,) top-left pixel of the 16x16 bilinear support
    c0: torch.Tensor
    cry: torch.Tensor  # (K,) current-block origin, fixed from uv_cur
    crx: torch.Tensor


def _template(prev, uv_prev, uv_cur, h) -> _Template:
    H, W = prev.shape
    pry, prx, cry, crx = _origins(uv_prev, uv_cur, H, W, h)
    uvp = torch.nan_to_num(uv_prev, nan=_NAN_POS)
    xp, yp = uvp[:, 0], uvp[:, 1]
    ixp, iyp = torch.floor(xp), torch.floor(yp)
    t_in = ((ixp - h >= 1) & (ixp + h + 2 <= W - 1)
            & (iyp - h >= 1) & (iyp + h + 2 <= H - 1))

    lx = xp - prx.to(torch.float32)
    ly = yp - pry.to(torch.float32)
    fix, fiy = torch.floor(lx), torch.floor(ly)
    r0 = pry + _floor_int(ly) - h
    c0 = prx + _floor_int(lx) - h
    gx_img, gy_img = pyr.scharr_gradients(prev)
    tmpl = _patch15(prev, r0, c0, lx - fix, ly - fiy)
    gx = _patch15(gx_img, r0, c0, lx - fix, ly - fiy)
    gy = _patch15(gy_img, r0, c0, lx - fix, ly - fiy)

    gxx = _sum225(gx * gx)
    gxy = _sum225(gx * gy)
    gyy = _sum225(gy * gy)
    det = gxx * gyy - gxy * gxy
    det_min = torch.full((), _DET_MIN, dtype=torch.float32,
                         device=prev.device)
    safe_det = torch.where(det > det_min, det, 1.0)
    inv = (gyy / safe_det, -gxy / safe_det, gxx / safe_det)
    return _Template(tmpl, gx, gy, inv, t_in, t_in & (det > det_min), r0, c0,
                     cry, crx)


def _step(cur, t: _Template, x, y, h):
    """One Gauss-Newton step -> (x, y, applied, r0, c0): the new position,
    whether the step applied, and the top-left pixel of the patch support
    it sampled."""
    H, W = cur.shape
    lx = x - t.crx.to(torch.float32)
    ly = y - t.cry.to(torch.float32)
    fix, fiy = torch.floor(lx), torch.floor(ly)
    c_inw = ((fiy - h >= 0) & (fiy + h + 1 < CB_R)
             & (fix - h >= 0) & (fix + h + 1 < BW))
    x0 = torch.floor(x) - h
    y0 = torch.floor(y) - h
    c_img = ((x0 >= 0) & (y0 >= 0) & (x0 + 2 * h + 1 < W)
             & (y0 + 2 * h + 1 < H))
    applied = t.ok & c_inw & c_img
    r0 = t.cry + _floor_int(ly) - h
    c0 = t.crx + _floor_int(lx) - h
    e = _patch15(cur, r0, c0, lx - fix, ly - fiy) - t.tmpl
    bx = _sum225(t.gx * e)
    by = _sum225(t.gy * e)
    inv00, inv01, inv11 = t.inv
    dx = inv00 * bx + inv01 * by
    dy = inv01 * bx + inv11 * by
    x = x - torch.where(applied, dx, 0.0)
    y = y - torch.where(applied, dy, 0.0)
    return x, y, applied, r0, c0


def _plain(prev, cur, uv_prev, uv_cur, h, iters):
    H, W = prev.shape
    t = _template(prev, uv_prev, uv_cur, h)
    uvc = torch.nan_to_num(uv_cur, nan=_NAN_POS)
    x, y = uvc[:, 0], uvc[:, 1]
    for _ in range(iters):
        x, y = _step(cur, t, x, y, h)[:2]
    inb = (x >= 1) & (x <= W - 2) & (y >= 1) & (y <= H - 2)
    return torch.stack([x, y], dim=-1), t.ok & inb


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, ...) with each sequence's block contiguous; the batch
    stride stays what it is (0 for an input shared by all)."""
    return x if x[0].is_contiguous() else x.contiguous()


def _launch(prev, cur, uv_prev, uv_cur, iters):
    """One kernel launch for a batch: images (B, H, W), positions
    (B, K, 2) -> (uv (B, K, 2), ok (B, K))."""
    prev, cur, uv_prev, uv_cur = map(_rows, (prev, cur, uv_prev, uv_cur))
    B, H, W = prev.shape
    K = uv_prev.shape[1]
    uv_out = torch.empty((B, K, 2), dtype=torch.float32, device=prev.device)
    ok_out = torch.empty((B, K), dtype=torch.bool, device=prev.device)
    _KERNEL.launch(prev, prev.data_ptr(), prev.stride(0), cur.data_ptr(),
                   cur.stride(0), H, W, uv_prev.data_ptr(), uv_prev.stride(0),
                   uv_cur.data_ptr(), uv_cur.stride(0), K, iters, B,
                   uv_out.data_ptr(), ok_out.data_ptr())
    return uv_out, ok_out


@torch.library.custom_op("velo_tpu_torch::klt_l0", mutates_args=())
def _batched(prev: torch.Tensor, cur: torch.Tensor, uv_prev: torch.Tensor,
             uv_cur: torch.Tensor,
             iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) twice, (B, K, 2) twice -> ((B, K, 2), (B, K)): on the
    card one launch, on the CPU the plain version per sequence."""
    if prev.device.type == "cuda":
        return _launch(prev, cur, uv_prev, uv_cur, iters)
    return torch.func.vmap(_plain, in_dims=(0, 0, 0, 0, None, None))(
        prev, cur, uv_prev, uv_cur, HALFWIN, iters)


@_batched.register_fake
def _(prev, cur, uv_prev, uv_cur, iters):
    B, K = uv_prev.shape[:2]
    return (uv_prev.new_empty((B, K, 2)),
            uv_prev.new_empty((B, K), dtype=torch.bool))


_build.register_vmap(_batched)


def track_level0(prev_img: torch.Tensor, cur_img: torch.Tensor,
                 uv_prev: torch.Tensor, uv_cur: torch.Tensor, cfg,
                 iters: int):
    """Level-0 IC-LK of K tracks -> (uv (K, 2) float32, ok (K,) bool).

    Args:
      prev_img, cur_img: (H, W) float32 images that :func:`fits`.
      uv_prev: (K, 2) template positions (x, y) in ``prev_img``.
      uv_cur: (K, 2) initial positions in ``cur_img``.
      cfg: a ``VisionConfig`` (``klt_halfwin`` must be 7).
      iters: Gauss-Newton steps.

    A CUDA tensor runs the kernel (one launch, counted as
    ``kernel.klt_l0`` in ``profiling.counters()``; under
    ``torch.func.vmap``, one launch for the whole batch); a CPU tensor runs
    the plain version.
    """
    _check(prev_img, cur_img, uv_prev, uv_cur, cfg, iters)
    if prev_img.device.type == "cuda":
        uv, ok = _batched(prev_img[None], cur_img[None], uv_prev[None],
                          uv_cur[None], iters)
        return uv[0], ok[0]
    if prev_img.device.type == "cpu":
        return _plain(prev_img, cur_img, uv_prev, uv_cur, HALFWIN, iters)
    raise ValueError(f"track_level0: unsupported device {prev_img.device}")


def track_level0_reference(prev_img, cur_img, uv_prev, uv_cur, cfg,
                           iters: int):
    """The plain PyTorch version of :func:`track_level0`, on any device."""
    _check(prev_img, cur_img, uv_prev, uv_cur, cfg, iters)
    return _plain(prev_img, cur_img, uv_prev, uv_cur, HALFWIN, iters)


def work(prev_img, cur_img, uv_prev, uv_cur, cfg, iters):
    """The work one call on these inputs needs, for a roofline bound ->
    (templates, steps, pixels): tracks whose template support lies inside
    the image, Gauss-Newton steps applied, and distinct image pixels read
    (the 18x18 bilinear-plus-Scharr support of each such template in the
    previous image, the 16x16 support of each applied step's patch in the
    current one)."""
    _check(prev_img, cur_img, uv_prev, uv_cur, cfg, iters)
    t = _template(prev_img, uv_prev, uv_cur, HALFWIN)
    seen_prev = _mark(prev_img.shape, t.r0[t.t_in] - 1, t.c0[t.t_in] - 1, 18)
    seen_cur = torch.zeros(cur_img.shape, dtype=torch.bool,
                           device=cur_img.device)
    uvc = torch.nan_to_num(uv_cur, nan=_NAN_POS)
    x, y = uvc[:, 0], uvc[:, 1]
    steps = 0
    for _ in range(iters):
        x, y, applied, r0, c0 = _step(cur_img, t, x, y, HALFWIN)
        seen_cur |= _mark(cur_img.shape, r0[applied], c0[applied], 16)
        steps += int(applied.sum())
    return (int(t.t_in.sum()), steps,
            int(seen_prev.sum()) + int(seen_cur.sum()))


def _mark(shape, r0, c0, size):
    """(H, W) bool mask of the size x size squares at top-left (r0, c0)."""
    H, W = shape
    ar = torch.arange(size, device=r0.device)
    rows = torch.clamp(r0[:, None] + ar, 0, H - 1)
    cols = torch.clamp(c0[:, None] + ar, 0, W - 1)
    mask = torch.zeros(shape, dtype=torch.bool, device=r0.device)
    mask[rows[:, :, None], cols[:, None, :]] = True
    return mask
