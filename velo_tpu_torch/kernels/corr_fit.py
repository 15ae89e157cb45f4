"""One launch per correspondence fit of an ICP outer iteration.

Every outer iteration of ``solve/icp``'s solves re-fits its edge and planar
correspondences at the current pose: each query's rows (the dense engine
re-ranks its cached candidates, the hash engine gives the rows of its
query), then the 2-point edge lines of the scan-to-scan solves or the PCA
lines of the map solve, and the PCA planes.  In plain PyTorch that is
~750 small kernels a call; ``corr_fit`` computes both sets as one launch
of the CUDA kernel ``csrc/corr_fit.cu`` (one thread per query).  It
takes CUDA tensors only; its plain version, :func:`corr_fit_reference`,
calls the plain functions (``icp._cand_query``, ``icp._edge_lines_2pt``,
``icp._planar_planes_fit``, ``residuals.fit_line_eig``) on any device.

It replaces no TPU kernel: the reference's fits are plain XLA.  The kernel
mirrors the plain path's float32 operations one for one and computes each
``fp`` helper in float64, rounded once, with the sums in the plain order,
so its outputs are the plain path's bits.  ``icp._fit`` takes this route
for every fit on the card and counts it as ``fit.kernel`` (``fit.plain``
elsewhere).  The card path is the custom operator
``velo_tpu_torch::corr_fit`` on a leading batch axis; under
``torch.func.vmap`` (``pipeline/batch``) its batching rule folds the
vmapped axis into that one and launches once.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from velo_tpu_torch.kernels import _build

MAX_ROWS, MAX_CANDIDATES = 16, 32  # the kernel's k and C (csrc/corr_fit.cu)
EDGE_2PT, EDGE_LINE, PLANE = 0, 1, 2  # the kernel's fit modes


class Rows(NamedTuple):
    """What a fit reads of one feature set, per query: with ``rerank`` the
    candidates of the dense engine's cache (Q, C), of which the fit keeps
    the k nearest to the moved query; without it the k rows of a hash
    query (Q, k), as given."""
    pts: torch.Tensor  # (Q, C, 3)
    payload: torch.Tensor  # (Q, C, P) int32; column 0 the ring id
    ok: torch.Tensor  # (Q, C) bool
    k: int  # rows fitted per query
    rerank: bool


class Fit(NamedTuple):
    """One outer iteration's correspondences: edge lines through (a, b) and
    planes (n, d), each with its gate and fit quality (``e_q`` None for the
    2-point lines)."""
    a: torch.Tensor  # (Qe, 3)
    b: torch.Tensor  # (Qe, 3)
    e_ok: torch.Tensor  # (Qe,)
    e_q: Optional[torch.Tensor]  # (Qe,)
    n: torch.Tensor  # (Qp, 3)
    d: torch.Tensor  # (Qp,)
    p_ok: torch.Tensor  # (Qp,)
    p_q: torch.Tensor  # (Qp,)


class _View(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p)] + [
        (s, ctypes.c_longlong) for s in ("sb", "s0", "s1", "s2")]


class FitSet(ctypes.Structure):
    """``FitSet`` of ``csrc/corr_fit.cu``."""
    _fields_ = ([(name, _View) for name in ("pts", "ring", "ok", "p",
                                            "mask")]
                + [(name, ctypes.c_void_p) for name in (
                    "out_u", "out_v", "out_d", "out_ok", "out_q")]
                + [(name, ctypes.c_int) for name in ("n", "c", "k", "mode")])


class Args(ctypes.Structure):
    """``CorrFitArgs`` of ``csrc/corr_fit.cu``."""
    _fields_ = [("set", FitSet * 2), ("batch", ctypes.c_int),
                ("rerank", ctypes.c_int), ("r2", ctypes.c_float)]


def _view(x: torch.Tensor | None) -> _View:
    if x is None:
        return _View(None, 0, 0, 0, 0)
    st = list(x.stride()) + [0, 0, 0]
    return _View(x.data_ptr(), *st[:4])


def _check(name, x, dtype, shape, device) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"corr_fit: {name} must be {dtype} of shape {shape}, "
                         f"not {x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"corr_fit: {name} is on {x.device}, the edge "
                         f"queries on {device}")


def _fit_set(pts, ring, ok, p, mask, k, mode, outs, device) -> FitSet:
    """One feature set's part of the arguments, after the batched contract:
    (B, Q, C, 3) float32 points, (B, Q, C) int32 rings (mode 0) and bool
    validity, (B, Q, 3) float32 queries, (B, Q) bool mask, 1 <= k <= C."""
    b, q = p.shape[0], p.shape[1]
    c = pts.shape[2] if pts.dim() == 4 else -1
    _check("pts", pts, torch.float32, (b, q, c, 3), device)
    _check("ok", ok, torch.bool, (b, q, c), device)
    _check("p", p, torch.float32, (b, q, 3), device)
    _check("mask", mask, torch.bool, (b, q), device)
    if mode == EDGE_2PT:
        if ring is None:
            raise ValueError("corr_fit: the 2-point edge lines need rings")
        _check("ring", ring, torch.int32, (b, q, c), device)
    if not 1 <= k <= min(c, MAX_ROWS) or c > MAX_CANDIDATES:
        raise ValueError(f"corr_fit: k = {k} rows of {c} candidates; the "
                         f"kernel takes k <= {MAX_ROWS}, C <= "
                         f"{MAX_CANDIDATES}")
    f = FitSet(_view(pts), _view(ring if mode == EDGE_2PT else None),
               _view(ok), _view(p), _view(mask))
    for name, x in outs.items():
        setattr(f, name, None if x is None else x.data_ptr())
    f.n, f.c, f.k, f.mode = q, c, k, mode
    return f


def _outputs(b, q, device, mode) -> dict:
    def empty(*shape, dtype=torch.float32):
        return torch.empty((b, q) + shape, dtype=dtype, device=device)

    return {"out_u": empty(3), "out_v": empty(3) if mode != PLANE else None,
            "out_d": empty() if mode == PLANE else None,
            "out_ok": empty(dtype=torch.bool), "out_q": empty()}


def args(e_pts, e_ring, e_ok, e_p, e_mask, p_pts, p_ok, p_p, p_mask,
         line: bool, k_edge: int, k_planar: int, rerank: bool,
         r2: float) -> tuple[Args, tuple]:
    """The kernel's arguments and its outputs (the operator's eight) for
    the operator's batched inputs (:func:`inputs`); ``r2`` rounds to
    float32 as PyTorch rounds the Python number where
    ``icp._cand_query`` meets it."""
    device = e_p.device
    e_mode = EDGE_LINE if line else EDGE_2PT
    b, qe, qp = e_p.shape[0], e_p.shape[1], p_p.shape[1]
    if p_p.shape[0] != b:
        raise ValueError("corr_fit: the two sets' batches differ")
    e = _outputs(b, qe, device, e_mode)
    p = _outputs(b, qp, device, PLANE)
    a = Args()
    a.set[0] = _fit_set(e_pts, e_ring, e_ok, e_p, e_mask, k_edge, e_mode, e,
                        device)
    a.set[1] = _fit_set(p_pts, None, p_ok, p_p, p_mask, k_planar, PLANE, p,
                        device)
    a.batch, a.rerank, a.r2 = b, int(rerank), np.float32(r2)
    return a, (e["out_u"], e["out_v"], e["out_ok"], e["out_q"], p["out_u"],
               p["out_d"], p["out_ok"], p["out_q"])


_KERNEL = _build.Entry("corr_fit", "corr_fit_launch", [ctypes.POINTER(Args)])


@torch.library.custom_op("velo_tpu_torch::corr_fit", mutates_args=())
def _batched(e_pts: torch.Tensor, e_ring: Optional[torch.Tensor],
             e_ok: torch.Tensor, e_p: torch.Tensor, e_mask: torch.Tensor,
             p_pts: torch.Tensor, p_ok: torch.Tensor, p_p: torch.Tensor,
             p_mask: torch.Tensor, line: bool, k_edge: int, k_planar: int,
             rerank: bool, r2: float
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor, torch.Tensor]:
    """B fits on a leading batch axis -> a, b (B, Qe, 3), e_ok, e_q (B, Qe),
    n (B, Qp, 3), d, p_ok, p_q (B, Qp): one launch (CUDA tensors only)."""
    _KERNEL.require_cuda(e_p)
    a, outs = args(e_pts, e_ring, e_ok, e_p, e_mask, p_pts, p_ok, p_p, p_mask,
                   line, k_edge, k_planar, rerank, r2)
    _KERNEL.launch(e_p, ctypes.byref(a))
    return outs


@_batched.register_fake
def _(e_pts, e_ring, e_ok, e_p, e_mask, p_pts, p_ok, p_p, p_mask, *rest):
    b, qe, qp = e_p.shape[0], e_p.shape[1], p_p.shape[1]
    return (e_p.new_empty((b, qe, 3)), e_p.new_empty((b, qe, 3)),
            e_p.new_empty((b, qe), dtype=torch.bool), e_p.new_empty((b, qe)),
            p_p.new_empty((b, qp, 3)), p_p.new_empty((b, qp)),
            p_p.new_empty((b, qp), dtype=torch.bool), p_p.new_empty((b, qp)))


_build.register_vmap(_batched)


def inputs(edge: Rows, pe, e_mask, planar: Rows, pp, p_mask, cfg,
           line: bool = False) -> tuple:
    """The operator's arguments for one problem (batch 1): the tensors of
    both sets with a leading batch axis (the rings only for the 2-point
    lines), then line, k of each set, rerank and corr_max_dist**2."""
    if edge.rerank != planar.rerank:
        raise ValueError("corr_fit: both sets re-rank, or neither")
    ring = None if line else edge.payload[..., 0]
    tensors = (edge.pts, ring, edge.ok, pe, e_mask, planar.pts, planar.ok, pp,
               p_mask)
    return (*(None if x is None else x[None] for x in tensors), line, edge.k,
            planar.k, edge.rerank, cfg.corr_max_dist ** 2)


def fit_of(outs, line: bool) -> Fit:
    """The :class:`Fit` of the operator's eight outputs, at batch 0."""
    a, b, e_ok, e_q, n, d, p_ok, p_q = (o[0] for o in outs)
    return Fit(a, b, e_ok, e_q if line else None, n, d, p_ok, p_q)


def corr_fit(edge: Rows, pe, e_mask, planar: Rows, pp, p_mask, cfg,
             line: bool = False) -> Fit:
    """One outer iteration's fit of both feature sets.

    Args:
      edge, planar: each set's :class:`Rows` (both re-ranked, or neither).
      pe (Qe, 3), pp (Qp, 3): the queries moved into the target frame;
        ``e_mask`` (Qe,), ``p_mask`` (Qp,) their masks.
      cfg: the ``SolverConfig`` (``corr_max_dist``).
      line: the map solve's PCA lines, else the 2-point edge lines.

    Returns the :class:`Fit` of one launch, counted as ``kernel.corr_fit``
    in ``profiling.counters()``.  The tensors must be on the card (else
    ``ValueError``).
    """
    return fit_of(_batched(*inputs(edge, pe, e_mask, planar, pp, p_mask, cfg,
                                   line)), line)


def _query(rows: Rows, cfg):
    """The plain path's ``query(p, mask, k)`` over ``rows``."""
    from velo_tpu_torch.solve import icp

    if rows.rerank:
        return icp._cand_query(
            icp.CandCache(pts=rows.pts, payload=rows.payload, ok=rows.ok),
            cfg)
    return lambda p, mask, k: (rows.pts, rows.payload, None, rows.ok)


def corr_fit_reference(edge: Rows, pe, e_mask, planar: Rows, pp, p_mask,
                       cfg, line: bool = False) -> Fit:
    """The plain version of :func:`corr_fit`, on any device: the fit
    closures' plain functions, unchanged."""
    from velo_tpu_torch.solve import icp
    from velo_tpu_torch.solve import residuals as res

    eq, pq = _query(edge, cfg), _query(planar, cfg)
    e_q = None
    if line:
        nbr, _, _, val = eq(pe, e_mask, edge.k)
        mu, direction, l_ok, e_q = res.fit_line_eig(nbr, val)
        # Two virtual points on the fitted line.
        a, b, e_ok = mu - 0.1 * direction, mu + 0.1 * direction, l_ok & e_mask
    else:
        a, b, e_ok = icp._edge_lines_2pt(eq, pe, e_mask)
    n, d, p_ok, p_q = icp._planar_planes_fit(pq, pp, p_mask, planar.k)
    return Fit(a, b, e_ok, e_q, n, d, p_ok, p_q)
