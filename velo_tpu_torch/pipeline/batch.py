"""Config 5: batched multi-sequence odometry, optionally sharded over the
cards (port of ``velo_tpu/pipeline/batch.py``).

B independent sequences advance in lockstep as one batched program:
``torch.func.vmap`` over :func:`odometry.step`, the counterpart of the
reference's ``jax.vmap`` over ``run_scan``.  One vmapped step per frame
makes about the launches of one sequence's step for all B, and each of
the two kernels (``dist_topk``, ``klt_l0``) launches once per call site
with a batch axis in its grid (their ``register_vmap`` rules).  Sequences
are independent, so ``shard=True`` splits the batch into contiguous
chunks, one per card, with no collective between them.

Two leaves of the carry stay outside the vmapped function: ``frame_host``
is one Python int for all B (the map cadences stay host decisions), and
``vision`` is None on the LiDAR-only path.  ``cam`` is one calibration
shared by all sequences, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from velo_tpu_torch.pipeline import odometry


def batched_step(cfg, cam=None):
    """``step(bcarry, scans, masks, images=None) -> (bcarry, FrameResult)``
    over a leading batch axis of every tensor; ``bcarry.frame_host`` is the
    shared host frame counter."""

    def run(bcarry, scans, masks, images=None):
        frame_host = bcarry.frame_host

        def one(carry, scan, mask, image):
            new, out = odometry.step(carry._replace(frame_host=frame_host),
                                     scan, mask, cfg, image=image, cam=cam)
            return new._replace(frame_host=None), out

        args = (bcarry._replace(frame_host=None), scans, masks, images)
        new, out = torch.func.vmap(
            one, in_dims=_batch_dims(args),
            out_dims=(_batch_dims(args[0]), 0))(*args)
        return new._replace(frame_host=frame_host + 1), out

    return run


def _batch_dims(tree):
    """vmap's in_dims / out_dims: 0 for each tensor, None for the None
    leaves (``frame_host`` inside, ``vision`` and ``image`` without
    vision)."""
    return pytree.tree_map(
        lambda x: 0 if isinstance(x, torch.Tensor) else None, tree)


def broadcast_carry(carry: odometry.OdomCarry, batch: int):
    """``carry`` with every tensor leaf expanded to a leading batch axis
    (a stride-0 view: the first step writes fresh tensors)."""
    return pytree.tree_map(
        lambda x: x.expand(batch, *x.shape) if isinstance(x, torch.Tensor)
        else x, carry)


def _shard_devices(device, devices):
    if devices is not None:
        return [torch.device(d) for d in devices]
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def run_sequences(scans: np.ndarray, masks: np.ndarray, cfg,
                  shard: bool = False, images: np.ndarray | None = None,
                  cam=None, device=None, devices=None):
    """Run B independent sequences as one batched program.

    Args:
      scans: (B, F, N_MAX, 4) float32 raw padded points, or, with
        ``cfg.prebin_host`` (the production loader layout), (B, F, R, W, 5)
        host-pre-binned grids.
      masks: (B, F, N_MAX) bool, or (B, F, R, W) with ``cfg.prebin_host``.
      shard: split the batch over ``devices`` (default: every visible card
        when ``device`` is one, else ``device`` alone) in contiguous
        chunks; B must be a multiple of their count.  With one device this
        is a no-op.
      images: (B, F, H, W) float32 when ``cfg.use_vision``; requires
        ``cam`` (one calibration shared by all sequences).
      device: where to run (default: the card; raises without one).

    Returns:
      (poses (B, F, 4, 4) numpy, diag dict of (B, F) numpy arrays)
    """
    if cfg.use_vision and (images is None or cam is None):
        raise ValueError("cfg.use_vision requires images and cam")
    device = odometry.resolve_device(device)
    B, F = scans.shape[:2]
    devs = _shard_devices(device, devices) if shard else [device]
    if B % len(devs):
        raise ValueError(f"batch {B} not divisible by {len(devs)} devices")
    n = B // len(devs)
    chunks = []
    for i, dev in enumerate(devs):
        chunk = slice(i * n, (i + 1) * n)
        c = cam.to(dev) if cfg.use_vision else None
        chunks.append({
            "dev": dev, "sl": chunk, "step": batched_step(cfg, cam=c),
            "carry": broadcast_carry(odometry.init_carry(cfg, dev), n),
            "outs": []})

    def put(x, dtype, dev):
        return torch.as_tensor(np.ascontiguousarray(x, dtype)).to(dev)

    for f in range(F):
        # Each card's step is queued before the next card's: the launches
        # are asynchronous, so the cards run their chunks side by side.
        for ch in chunks:
            dev, sl = ch["dev"], ch["sl"]
            image = (put(images[sl, f], np.float32, dev) if cfg.use_vision
                     else None)
            ch["carry"], out = ch["step"](
                ch["carry"], put(scans[sl, f], np.float32, dev),
                put(masks[sl, f], bool, dev), image)
            ch["outs"].append(out)

    res = {k: np.concatenate([
        torch.stack([getattr(o, k) for o in ch["outs"]], dim=1).cpu().numpy()
        for ch in chunks]) for k in odometry.FrameResult._fields}
    poses = res.pop("T_w")
    return poses, res
