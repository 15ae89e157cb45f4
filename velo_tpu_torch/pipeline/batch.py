"""Config 5: batched multi-sequence odometry, optionally sharded over the
cards (port of ``velo_tpu/pipeline/batch.py``).

B independent sequences advance in lockstep as one batched program:
``torch.func.vmap`` over :func:`odometry.step`, the counterpart of the
reference's ``jax.vmap`` over ``run_scan``.  One vmapped step per frame
makes about the launches of one sequence's step for all B, and each of
the two kernels (``dist_topk``, ``klt_l0``) launches once per call site
with a batch axis in its grid (their ``register_vmap`` rules).
:func:`batched_run_scan` runs the frames of (B, F, ...) inputs on one
device; on the card each batched step is one replay of a captured CUDA
graph (``pipeline/graphs.py``).  Sequences are independent, so
``shard=True`` splits the batch into contiguous chunks, one per card,
with no collective between them.

Two leaves of the carry stay outside the vmapped function: ``frame_host``
is one Python int for all B (the map cadences stay host decisions), and
``vision`` is None on the LiDAR-only path.  ``cam`` is one calibration
shared by all sequences, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from velo_tpu_torch.pipeline import graphs, odometry


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


def jit_batched_step(cfg, cam=None):
    """:func:`batched_step` as one device program: on the card one replay
    of a CUDA graph of it per call (one graph per cadence key,
    ``pipeline/graphs.py``; the returned carry is the graph's static
    carry, as with ``odometry.jit_step``), on the CPU the batched step
    itself."""

    def fn(bcarry, scans, masks, images, c):
        return batched_step(cfg, cam=c)(bcarry, scans, masks, images)

    def run(bcarry, scans, masks, images=None):
        inputs = (scans, masks, images, cam)
        if scans.device.type != "cuda":
            return fn(bcarry, *inputs)
        return graphs.runner("batch.batched_step", cfg, fn, bcarry, inputs,
                             lambda fh: odometry.cadence_key(cfg, fh))(
                                 bcarry, *inputs)

    return run


def batched_run_scan(cfg, cam=None):
    """The reference's ``batched_run_scan``: ``run(bcarry, bscans, bmasks
    [, bimages]) -> (final bcarry, FrameResult)`` over (B, F, ...) inputs
    on one device, each result field (B, F, ...): one
    :func:`jit_batched_step` per frame (on the card one graph replay).
    ``cam`` (one calibration for all sequences) selects the fused
    pipeline, which takes the (B, F, H, W) image stack."""
    step = jit_batched_step(cfg, cam)

    def run(bcarry, bscans, bmasks, bimages=None):
        if (cam is None) != (bimages is None):
            raise ValueError("batched_run_scan: images go with cam")
        outs = []
        for f in range(bscans.shape[1]):
            bcarry, out = step(bcarry, bscans[:, f], bmasks[:, f],
                               None if bimages is None else bimages[:, f])
            outs.append(out)
        if not outs:
            raise ValueError("batched_run_scan: no frames")
        if bscans.device.type == "cuda":
            bcarry = graphs.clone(bcarry)
        return bcarry, odometry.FrameResult(*(
            torch.stack([getattr(o, k) for o in outs], dim=1)
            for k in odometry.FrameResult._fields))

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

    def put(x, dtype, dev, sl):
        return torch.as_tensor(np.ascontiguousarray(x[sl], dtype)).to(dev)

    # All frames go to their card at once, as the reference puts the whole
    # (B, F, ...) stack on the device; each card's run is queued before
    # the next card's: replays are asynchronous, so the cards run their
    # chunks side by side.
    results = []
    for i, dev in enumerate(devs):
        sl = slice(i * n, (i + 1) * n)
        run = batched_run_scan(cfg, cam=cam.to(dev) if cfg.use_vision
                               else None)
        ins = [put(scans, np.float32, dev, sl), put(masks, bool, dev, sl)]
        if cfg.use_vision:
            ins.append(put(images, np.float32, dev, sl))
        results.append(run(broadcast_carry(odometry.init_carry(cfg, dev), n),
                           *ins)[1])

    res = {k: np.concatenate([getattr(r, k).cpu().numpy() for r in results])
           for k in odometry.FrameResult._fields}
    poses = res.pop("T_w")
    return poses, res
