"""The benchmark's traffic generator: a simulated KITTI-like drive from a
seed, with the frozen copy of the program's simulator (``fixtures.py``,
``accel.py``).  Nothing here imports the program."""
from __future__ import annotations

import dataclasses

import numpy as np


def simulate(conf: dict, seed: int, device):
    """The drive of configuration file ``conf`` for ``seed``, raycast on
    ``device``: a ``fixtures.Fixture`` of ``conf["sequence_frames"]`` raw
    (N, 4) float32 sweeps, with camera frames where the configuration
    uses vision.  Where the drive names a ``camera`` size, the frames are
    rendered at it and resized to the configuration's, as the user's
    loader resizes the camera's frames (:func:`resize`)."""
    from benchmarks.drive import fixtures

    vc, lc, d = (conf["velo_config"]["vision"], conf["velo_config"]["lidar"],
                 conf["drive"])
    vision = conf["velo_config"]["use_vision"]
    cam = d.get("camera", {"height": vc["height"], "width": vc["width"]})
    fx = fixtures.make_fixture(
        n_frames=conf["sequence_frames"], n_rings=lc["n_rings"],
        n_azimuth=lc["n_azimuth"], height=cam["height"], width=cam["width"],
        with_images=vision, speed=d["speed"],
        noise_std=d["noise_std"], seed=seed, yaw_rate=d["yaw_rate"],
        wiggle_scale=d["wiggle_scale"], dropout=d["dropout"],
        device=device)
    if vision and (cam["height"], cam["width"]) != (vc["height"],
                                                    vc["width"]):
        images, P = resize(fx.images, fx.P, vc["height"], vc["width"],
                           device)
        fx = dataclasses.replace(fx, images=images, P=P)
    return fx


def resize(images: np.ndarray, P: np.ndarray, height: int, width: int,
           device):
    """(F, H, W) float32 frames resized to (height, width) on ``device``,
    antialiased bilinear (torchvision's ``Resize`` of a tensor), and the
    projection matrix of the resized frames.  Pixel (u, v) lies at (u, v):
    the resize maps pixel u' to (u' + 0.5) s - 0.5 of the source, s the
    ratio of the widths (heights for v)."""
    import torch
    import torch.nn.functional as F

    src = torch.from_numpy(images).to(device)[:, None]
    out = F.interpolate(src, size=(height, width), mode="bilinear",
                        align_corners=False, antialias=True)[:, 0]
    sx, sy = images.shape[2] / width, images.shape[1] / height
    S = np.array([[1 / sx, 0.0, 0.5 / sx - 0.5],
                  [0.0, 1 / sy, 0.5 / sy - 0.5],
                  [0.0, 0.0, 1.0]])
    return (np.ascontiguousarray(out.cpu().numpy(), np.float32),
            S @ np.asarray(P, np.float64))
