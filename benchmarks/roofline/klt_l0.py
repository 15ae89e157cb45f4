"""Work of the ``klt_l0`` kernel per fused odometry frame, counted from the
slots and iterations the configuration fixes (frozen from
``chip_smoke.py``'s bound and ``velo_tpu_torch.kernels.klt_l0.work``).

A frame tracks its K track slots at pyramid level 0 twice: forward with
``klt_iters`` Gauss-Newton steps and backward (the consistency check) with
``klt_iters_fb``.  The timed path returns neither how many slots hold a
track inside the image nor how many steps applied, so every slot and every
iteration is counted: an upper count of the work, which can only raise the
share.  Per slot: a template (three 15 x 15 bilinear patches, Scharr
gradients on the 16 x 16 support, three 225-term product sums) and per
step one patch, its error and two 225-term product sums.  Bytes: the
18 x 18 support of the template in the previous image and the 16 x 16
support of the patch in the current one (the steps move it by sub-pixel
amounts), each capped at the image's pixels, float32; positions in (two
(K, 2) float32) and out ((K, 2) float32 and a bool per slot).
"""
from __future__ import annotations

from benchmarks import roofline

TEMPLATE_OPS = 3 * 1397 + 4608 + 1347
STEP_OPS = 1397 + 225 + 898 + 8


def call_work(k: int, iters: int, height: int, width: int
              ) -> tuple[float, float]:
    """(bytes, float32 operations) of one call over k slots."""
    pixels = min(k * 18 * 18, height * width) + min(k * 16 * 16,
                                                    height * width)
    n_bytes = pixels * 4 + 2 * k * 8 + k * 9
    return n_bytes, k * (TEMPLATE_OPS + iters * STEP_OPS)


def frame_calls(cfg) -> list[int]:
    """Gauss-Newton iterations of each call a frame makes; [] where the
    kernel is off the path."""
    if not cfg.use_vision or cfg.vision.klt_impl != "pallas":
        return []
    return [cfg.vision.klt_iters, cfg.vision.klt_iters_fb]


def frame_least_seconds(cfg) -> float:
    vc = cfg.vision
    return sum(roofline.least_seconds(*call_work(
        vc.k_tracks, iters, vc.height, vc.width)) for iters in frame_calls(cfg))
