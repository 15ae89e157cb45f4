"""Brute-force k-nearest-neighbours, the dense correspondence engine
(port of ``velo_tpu/mapping/dense_nn.py``).

The approximate path (candidate preselection) goes through the fused
``kernels.dist_topk``, which never materializes the Q x N distance field.
The exact path is one distance matmul plus a stable sort, for shapes the
kernel does not take, for ``approx_impl="xla"`` (the reference's
``approx_max_k``, exact off the TPU) and for tests.  Distances are
float32 throughout: a reduced-precision matmul mis-ranks
centimetre-scale near-ties.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmarks.reference import fp
from benchmarks.reference.kernels import dist_topk as dtk

APPROX_IMPLS = ("pallas", "xla")


class TargetSet(NamedTuple):
    """A fixed-shape NN target cloud (no build step needed)."""

    pts: torch.Tensor  # (N, 3)
    mask: torch.Tensor  # (N,)
    payload: torch.Tensor  # (N, P) e.g. ring ids; may be (N, 0)


def make_targets(pts, mask, payload=None) -> TargetSet:
    if payload is None:
        payload = torch.zeros((pts.shape[0], 0), dtype=torch.int32,
                              device=pts.device)
    return TargetSet(pts=pts, mask=mask, payload=payload)


def knn(targets: TargetSet, queries: torch.Tensor, qmask: torch.Tensor,
        k: int, max_dist: float, approx: bool = False,
        approx_impl: str = "pallas"):
    """Masked kNN.  Returns (idx (Q,k) int32 into targets.pts, dist (Q,k),
    valid (Q,k)); invalid lanes carry large distances.

    ``approx=True`` with ``approx_impl="pallas"`` routes to the binned
    ``dist_topk`` kernel when N % 256 == 0 and N >= 16k (``bin_factor`` 32
    from N >= 16384, else 4), exactly as the reference dispatches its
    Pallas kernel; other shapes, and ``approx_impl="xla"`` (XLA's
    ``approx_max_k``, an exact top-k off the TPU), take the exact search.
    """
    if approx_impl not in APPROX_IMPLS:
        raise ValueError(f"unknown nn_approx_impl {approx_impl!r}")
    t = targets.pts
    q = queries
    if (approx and approx_impl == "pallas" and t.shape[0] % 256 == 0
            and t.shape[0] >= 16 * k):
        bf = 32 if t.shape[0] >= 16384 else 4
        d2, idx = dtk.dist_topk(t, targets.mask, q, k=k, bin_factor=bf)
        d2 = torch.where(qmask[:, None], d2, 1e30)
        valid = d2 <= max_dist * max_dist
        dist = fp.sqrt(torch.clamp(d2, max=1e12))
        return idx, dist, valid
    # |q - t|^2 = |q|^2 - 2 q.t + |t|^2 ; the cross term is one matmul.
    cross = fp.matmul(q, t.T)
    q2 = fp.dot3(q, q)[:, None]
    t2 = fp.dot3(t, t)
    d2 = q2 - 2.0 * cross + t2[None, :]
    big = 1e30
    d2 = torch.where(targets.mask[None, :], d2, big)
    d2 = torch.where(qmask[:, None], d2, big)
    # Stable sort = lax.top_k's lower-index-first order among ties.
    neg, idx = torch.sort(-d2, dim=1, descending=True, stable=True)
    neg, idx = neg[:, :k], idx[:, :k].to(torch.int32)
    neg = torch.where(neg <= -big * 0.5, -torch.inf, neg)
    dist2 = torch.clamp(-neg, min=0.0)
    valid = torch.isfinite(dist2) & (dist2 <= max_dist * max_dist)
    dist = fp.sqrt(torch.where(torch.isfinite(dist2), dist2, 1e12))
    return idx, dist, valid
