"""Fused distance + binned top-k, plain PyTorch only.

Frozen copy of the plain version of ``velo_tpu_torch.kernels.dist_topk``
for the benchmark's reference.  For every query it returns k approximate
nearest targets: queries are ranked by

    s = [q | 1] . [-2t | |t|^2 (+1e30 where masked)]^T      (d2 = s + |q|^2)

each tile of TN targets is folded ``bin_factor`` ways into strided bins
(element j of a tile goes to bin j mod TN/B; a strict '<' keeps the earlier
element), and k rounds of first-index argmin over all bins pick the
winners.  A true neighbour is lost only when two of them share a bin.
Masked targets and already-extracted bins both read exactly 1e30, so a
query with fewer than k live bins gets duplicate indices in its trailing
lanes.
"""
from __future__ import annotations

import torch

from benchmarks.reference import fp

_BIG = 1e30
_TQ = 256  # query padding granule of the reference layout

def _pick_tile(n: int) -> int:
    for tn in (4096, 3072, 2048, 1024, 512, 256):
        if n % tn == 0:
            return tn
    raise ValueError(f"N={n} must be a multiple of 256")


def _tiles(n: int, k: int, bin_factor: int):
    tn = _pick_tile(n)
    nbt = tn // bin_factor if bin_factor > 0 else 0
    if nbt * bin_factor != tn or not 0 < k <= n // bin_factor:
        raise ValueError(f"bin_factor={bin_factor}, k={k} do not fit N={n}")
    return tn, nbt


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


def _finish(queries, s_sel, idx):
    q_n = queries.shape[0]
    s_sel = s_sel[:q_n]
    idx = idx[:q_n].clamp_min(0)
    q2 = fp.dot3(queries, queries)[:, None]
    return torch.clamp(s_sel + q2, min=0.0), idx


def dist_topk(targets: torch.Tensor, tmask: torch.Tensor,
              queries: torch.Tensor, k: int = 16, bin_factor: int = 16):
    """Approximate k-nearest targets for every query, on any device: the
    plain version (the program's kernel is not part of the reference).

    Returns (d2 (Q, k) float32 ascending, idx (Q, k) int32)."""
    return dist_topk_reference(targets, tmask, queries, k, bin_factor)


def dist_topk_reference(targets: torch.Tensor, tmask: torch.Tensor,
                        queries: torch.Tensor, k: int = 16,
                        bin_factor: int = 16):
    """The plain PyTorch version of :func:`dist_topk`, on any device."""
    m, q_aug, tn, nbt = _prepare(targets, tmask, queries, k, bin_factor)
    return _finish(queries, *_select_plain(q_aug, m, tn, nbt, k))
