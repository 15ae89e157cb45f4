"""Config 5 over several processes: the sequence batch sharded across
processes (port of ``velo_tpu/pipeline/distributed.py``).

Sequences are independent, so each process runs its own local sequences
through :func:`batch.run_sequences` on its card and gets its own shard of
the result back; the only collective is the optional global mean cost,
one ``all_reduce`` of a (sum, count) pair.

The caller sets up the process group first, as the reference's caller
calls ``jax.distributed.initialize``:

    torch.distributed.init_process_group(
        "gloo", init_method="tcp://<host>:<port>", world_size=n, rank=r)
    poses, diag = run_sequences_multihost(local_scans, local_masks, cfg)

Nothing here reads a cluster or an environment variable.  The pair is
reduced on the host, so the group needs gloo (``"gloo"``, or
``"cpu:gloo,cuda:nccl"``): two processes may share one card, which NCCL
refuses, and the odometry itself needs no collective.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from velo_tpu_torch.pipeline import batch as batch_mod


def run_sequences_multihost(scans_local: np.ndarray, masks_local: np.ndarray,
                            cfg, images_local: np.ndarray | None = None,
                            cam=None, with_global_cost: bool = False,
                            device=None):
    """Run this process's shard of the global sequence batch.

    Args:
      scans_local: (B_local, F, N_MAX, 4), or (B_local, F, R, W, 5) with
        ``cfg.prebin_host``: this process's sequences.
      masks_local: (B_local, F, N_MAX) bool, or (B_local, F, R, W).
      images_local: (B_local, F, H, W) float32 when ``cfg.use_vision``.
      with_global_cost: also return the mean of ``cost`` over every frame
        of every process's sequences.
      device: where this process runs (default: the card).

    Returns:
      (poses (B_local, F, 4, 4), diag dict of (B_local, F) arrays
       [, global mean cost float]): the local shard of the global result.
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("run_sequences_multihost needs "
                           "torch.distributed.init_process_group first")
    if cfg.use_vision and (images_local is None or cam is None):
        raise ValueError("cfg.use_vision requires images_local and cam")
    poses, diag = batch_mod.run_sequences(
        scans_local, masks_local, cfg, images=images_local, cam=cam,
        device=device)
    if not with_global_cost:
        return poses, diag
    dist.barrier()
    cost = np.asarray(diag["cost"], np.float64)
    pair = torch.tensor([cost.sum(), cost.size], dtype=torch.float64)
    dist.all_reduce(pair)
    return poses, diag, float(pair[0] / pair[1])
