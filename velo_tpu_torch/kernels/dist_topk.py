"""Fused distance + binned top-k (candidate preselection).

Port of ``velo_tpu/pallas/dist_topk.py``.  For every query it returns k
approximate nearest targets: queries are ranked by

    s = [q | 1] . [-2t | |t|^2 (+1e30 where masked)]^T      (d2 = s + |q|^2)

each tile of TN targets is folded ``bin_factor`` ways into strided bins
(element j of a tile goes to bin j mod TN/B; a strict '<' keeps the earlier
element), and k rounds of first-index argmin over all bins pick the
winners.  A true neighbour is lost only when two of them share a bin.

``dist_topk`` launches the CUDA kernel ``csrc/dist_topk.cu`` for tensors on
a GPU and runs the plain PyTorch version ``dist_topk_reference`` for tensors
on the CPU; it never falls back from one to the other.  On the card a call
is two ``torch.empty`` outputs and one launch on the raw inputs: the kernel
forms ``m``, |q|^2, the clamp and the indices itself, in the plain version's
operation order and roundings, so the two agree bitwise.  The launch
geometry is :func:`launch_geometry`, a pure function of the shapes.

The card path is the custom operator ``velo_tpu_torch::dist_topk`` on a
leading batch axis.  Under ``torch.func.vmap`` (the batched odometry step,
``pipeline/batch.py``) its batching rule merges the vmapped axis into that
one and launches once for all sequences, an input shared by all of them at
batch stride 0; on the CPU ``vmap`` traces the plain version's operations.

Masked targets and already-extracted bins both read exactly 1e30 (the f32
sum absorbs |t|^2), so a query with fewer than k live bins gets duplicate
indices in its trailing lanes — as in the reference.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from velo_tpu_torch import fp
from velo_tpu_torch.kernels import _build

_BIG = 1e30
_TQ = 256  # query padding granule of the reference layout
_SMS = 132  # streaming multiprocessors of the H100
_MAX_SMEM = 232448  # bytes of shared memory one block can use there
_THREADS = 256
_TQ_CHOICES = (8, 4, 2, 1)  # the kernel's register tiles of queries

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_KERNEL = _build.Entry("dist_topk", "dist_topk_launch", [
    _p, _ll, _ll, _ll, _p, _ll, _ll, _p, _ll, _ll, _ll,
    _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _p, _p])


def _pick_tile(n: int) -> int:
    for tn in (4096, 3072, 2048, 1024, 512, 256):
        if n % tn == 0:
            return tn
    raise ValueError(f"N={n} must be a multiple of 256")


class Geometry(NamedTuple):
    """How one call is cut for the kernel."""
    tn: int  # targets per tile (the reference's)
    nbt: int  # bins per tile, tn // bin_factor
    nb: int  # bins per query, n // bin_factor
    tq: int  # queries per block, held in each thread's registers
    threads: int  # per block; warp w extracts query w of the block
    blocks: int  # per sequence, ceil(q / tq): the grid's x; y is the batch
    smem_bytes: int  # the bins' minima: per query 32 columns of bins at
    # an odd stride, 4 * tq * 32 * (ceil(nb / 32) | 1)


def _tiles(n: int, k: int, bin_factor: int):
    tn = _pick_tile(n)
    nbt = tn // bin_factor if bin_factor > 0 else 0
    if nbt * bin_factor != tn or not 0 < k <= n // bin_factor:
        raise ValueError(f"bin_factor={bin_factor}, k={k} do not fit N={n}")
    return tn, nbt


@functools.lru_cache(maxsize=None)
def launch_geometry(q: int, n: int, bin_factor: int, k: int,
                    batch: int = 1) -> Geometry:
    """The kernel's launch geometry for ``batch`` sequences of Q queries
    against N targets: the largest register tile of queries that still
    gives every SM a block (``batch * ceil(q / tq) >= 132``) and whose bins
    fit a block's shared memory.  The kernel equals the plain version at
    every tile, so the batch changes no result.  Raises ValueError on
    shapes the kernel does not take."""
    if q < 1:
        raise ValueError(f"Q={q}: the kernel needs at least one query")
    if not 1 <= batch <= 65535:
        raise ValueError(f"batch={batch}: the grid's y axis takes 1-65535")
    tn, nbt = _tiles(n, k, bin_factor)
    nb = (n // tn) * nbt
    per_query = 4 * 32 * (-(-nb // 32) | 1)
    fits = [tq for tq in _TQ_CHOICES if tq * per_query <= _MAX_SMEM]
    if not fits:
        raise ValueError(f"N={n}, bin_factor={bin_factor}: {nb} bins per "
                         f"query exceed {_MAX_SMEM} bytes of shared memory")
    tq = next((t for t in fits if batch * -(-q // t) >= _SMS), fits[-1])
    return Geometry(tn, nbt, nb, tq, _THREADS, -(-q // tq), tq * per_query)


def _check(targets, tmask, queries):
    """The per-sequence contract: (N, 3), (N,), (Q, 3)."""
    if targets.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError("targets and queries must be float32")
    if tmask.dtype != torch.bool:
        raise TypeError("tmask must be bool")
    if not (targets.device == tmask.device == queries.device):
        raise ValueError("targets, tmask and queries must share a device")
    n = targets.shape[0]
    if targets.shape != (n, 3) or tmask.shape != (n,) or (
            queries.ndim != 2 or queries.shape[1] != 3):
        raise ValueError(
            f"bad shapes {tuple(targets.shape)}, {tuple(tmask.shape)}, "
            f"{tuple(queries.shape)}")


def _prepare(targets, tmask, queries, k, bin_factor):
    _check(targets, tmask, queries)
    tn, nbt = _tiles(targets.shape[0], k, bin_factor)

    t2 = fp.dot3(targets, targets)
    m = torch.cat(
        [-2.0 * targets, (t2 + torch.where(tmask, 0.0, _BIG))[:, None]],
        dim=-1).T.contiguous()  # (4, N)
    q_n = queries.shape[0]
    q_aug = torch.cat([queries, torch.ones_like(queries[:, :1])], dim=-1)
    q_aug = torch.nn.functional.pad(q_aug, (0, 0, 0, (-q_n) % _TQ))
    return m, q_aug.contiguous(), tn, nbt


def _select_plain(q_aug, m, tn, nbt, k):
    """Bin fold + k extraction rounds in plain PyTorch (materializes Q x N)."""
    n = m.shape[1]
    qp = q_aug.shape[0]
    q = q_aug
    # Same operation order as the kernel: separate mul and add kernels,
    # no fused multiply-add.
    s = q[:, 0:1] * m[0][None, :] + q[:, 1:2] * m[1][None, :]
    s = s + q[:, 2:3] * m[2][None, :]
    s = s + q[:, 3:4] * m[3][None, :]
    tiles, fold = n // tn, tn // nbt
    s = s.view(qp, tiles, fold, nbt)
    mn = s[:, :, 0]
    ag = torch.zeros(mn.shape, dtype=torch.int32, device=s.device)
    for i in range(1, fold):
        c = s[:, :, i]
        take = c < mn
        mn = torch.where(take, c, mn)
        ag = torch.where(take, i, ag)
    lane = torch.arange(nbt, dtype=torch.int32, device=s.device)
    tile0 = torch.arange(tiles, dtype=torch.int32, device=s.device) * tn
    gidx = tile0[None, :, None] + ag * nbt + lane
    nb = tiles * nbt
    vals = mn.reshape(qp, nb)
    idxs = gidx.reshape(qp, nb)

    bins = torch.arange(nb, device=s.device)
    out_v, out_i = [], []
    for _ in range(k):
        v = torch.amin(vals, dim=1, keepdim=True)
        pos = torch.amin(torch.where(vals == v, bins, nb), dim=1, keepdim=True)
        out_v.append(v)
        out_i.append(torch.gather(idxs, 1, pos))
        vals = torch.where(bins == pos, _BIG, vals)
    return torch.cat(out_v, dim=1), torch.cat(out_i, dim=1)


def _launch(targets, tmask, queries, k, bin_factor):
    """One kernel launch for a batch: targets (B, N, 3), tmask (B, N),
    queries (B, Q, 3), any strides (a batch stride of 0 shares an input)
    -> (d2, idx), each (B, Q, k)."""
    b, q, n = queries.shape[0], queries.shape[1], targets.shape[1]
    g = launch_geometry(q, n, bin_factor, k, b)
    d2 = torch.empty((b, q, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((b, q, k), dtype=torch.int32, device=queries.device)
    _KERNEL.launch(queries, targets.data_ptr(), *targets.stride(),
                   tmask.data_ptr(), *tmask.stride(), queries.data_ptr(),
                   *queries.stride(), b, q, n, g.tn, g.nbt, k, g.tq,
                   g.threads, g.blocks, g.smem_bytes, d2.data_ptr(),
                   idx.data_ptr())
    return d2, idx


@torch.library.custom_op("velo_tpu_torch::dist_topk", mutates_args=())
def _batched(targets: torch.Tensor, tmask: torch.Tensor,
             queries: torch.Tensor, k: int,
             bin_factor: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 3), (B, N), (B, Q, 3) -> (B, Q, k) twice: on the card one
    launch, on the CPU the plain version per sequence."""
    if targets.device.type == "cuda":
        return _launch(targets, tmask, queries, k, bin_factor)
    return torch.func.vmap(dist_topk_reference,
                           in_dims=(0, 0, 0, None, None))(
        targets, tmask, queries, k, bin_factor)


@_batched.register_fake
def _(targets, tmask, queries, k, bin_factor):
    shape = (queries.shape[0], queries.shape[1], k)
    return (queries.new_empty(shape),
            queries.new_empty(shape, dtype=torch.int32))


_build.register_vmap(_batched)


def _finish(queries, s_sel, idx):
    q_n = queries.shape[0]
    s_sel = s_sel[:q_n]
    idx = idx[:q_n].clamp_min(0)
    q2 = fp.dot3(queries, queries)[:, None]
    return torch.clamp(s_sel + q2, min=0.0), idx


def dist_topk(targets: torch.Tensor, tmask: torch.Tensor,
              queries: torch.Tensor, k: int = 16, bin_factor: int = 16):
    """Approximate k-nearest targets for every query.

    Args:
      targets: (N, 3) float32, N a multiple of 256.
      tmask: (N,) bool; masked targets rank last (d2 ~ 1e30).
      queries: (Q, 3) float32.
      k: neighbours per query.
      bin_factor: B-way fold of each target tile.

    Returns (d2 (Q, k) float32 ascending, idx (Q, k) int32).  A CUDA tensor
    runs the kernel (one launch, counted as ``kernel.dist_topk`` in
    ``profiling.counters()``; under ``torch.func.vmap``, one launch for the
    whole batch); a CPU tensor runs :func:`dist_topk_reference`'s plain
    path.
    """
    if targets.device.type == "cuda":
        _check(targets, tmask, queries)
        d2, idx = _batched(targets[None], tmask[None], queries[None], k,
                           bin_factor)
        return d2[0], idx[0]
    if targets.device.type == "cpu":
        return dist_topk_reference(targets, tmask, queries, k, bin_factor)
    raise ValueError(f"dist_topk: unsupported device {targets.device}")


def dist_topk_reference(targets: torch.Tensor, tmask: torch.Tensor,
                        queries: torch.Tensor, k: int = 16,
                        bin_factor: int = 16):
    """The plain PyTorch version of :func:`dist_topk`, on any device."""
    m, q_aug, tn, nbt = _prepare(targets, tmask, queries, k, bin_factor)
    return _finish(queries, *_select_plain(q_aug, m, tn, nbt, k))
