"""Geometric and visual residuals, robust losses and PCA fits
(port of ``velo_tpu/solve/residuals.py``).

Pose perturbation model (left, translation-first): for a point already
mapped into the target frame, ``d(exp(xi) p)/d xi = [I | -hat(p)]``, and
every scalar residual Jacobian is ``(dr/dp) @ [I | -hat(p)]``.
"""
from __future__ import annotations

import torch

from velo_tpu_torch import fp
from velo_tpu_torch.geom import se3
from velo_tpu_torch.geom.linalg import sym_eig3x3

_EPS = 1e-9


def point_jacobian(p: torch.Tensor) -> torch.Tensor:
    """(…,3) point -> (…,3,6) d(exp(xi) p)/d xi at xi=0."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(
        p.shape[:-1] + (3, 3))
    return torch.cat([eye, -se3.hat(p)], dim=-1)


def point_to_line(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  valid: torch.Tensor):
    """Distance of points p to lines through (a, b) -> (r, dr_dp, ok)."""
    u = b - a
    un = fp.norm3(u)
    ok = valid & (un > 1e-4)
    u_hat = u / torch.clamp(un, min=1e-4)[..., None]
    w = p - a
    v = w - fp.dot3(w, u_hat)[..., None] * u_hat
    d = fp.norm3(v)
    dr_dp = v / torch.clamp(d, min=1e-6)[..., None]
    ok = ok & (d > 1e-7)  # zero-distance gradient undefined; r=0 anyway
    return d, dr_dp, ok


def point_to_plane(p: torch.Tensor, n: torch.Tensor, d0: torch.Tensor,
                   valid: torch.Tensor):
    """Signed distance of points p to planes (unit n, offset d0)."""
    return fp.dot3(n, p) + d0, n, valid


def plane_from_3pts(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    valid: torch.Tensor, min_area: float = 1e-3):
    """Unit planes (n, d) through point triples, gated on
    non-collinearity -> (n_hat, d, ok)."""
    n = fp.cross3(b - a, c - a)
    nn = fp.norm3(n)
    ok = valid & (nn > min_area)
    n_hat = n / torch.clamp(nn, min=min_area)[..., None]
    return n_hat, -fp.dot3(n_hat, a), ok


def reprojection(p_cam: torch.Tensor, P: torch.Tensor, obs_uv: torch.Tensor,
                 valid: torch.Tensor):
    """Pinhole reprojection residual and its Jacobian wrt the camera-frame
    point -> (r (K, 2), dr_dp (K, 2, 3), ok).  With P = [M | p4] and
    x = M p + p4: du/dp = (M0 - u M2) / x2, dv/dp = (M1 - v M2) / x2."""
    ph = torch.cat([p_cam, torch.ones_like(p_cam[..., :1])], dim=-1)
    x = fp.einsum("ij,...j->...i", P, ph)
    z = x[..., 2]
    ok = valid & (z > 0.1)
    safe_z = torch.where(ok, z, 1.0)
    uv = x[..., :2] / safe_z[..., None]
    r = uv - obs_uv
    M = P[:3, :3]
    du_dp = (M[0] - uv[..., 0:1] * M[2]) / safe_z[..., None]
    dv_dp = (M[1] - uv[..., 1:2] * M[2]) / safe_z[..., None]
    return r, torch.stack([du_dp, dv_dp], dim=-2), ok


MIN_BASELINE = 0.05  # m: the epipolar residual's baseline gate


def normalized_tracks(K, uv_prev, uv_cur):
    """The tracks' homogeneous pixel coordinates through K^-1, in float64:
    (x1, x2), the pose-free part of :func:`_epipolar64`."""
    # inv_ex: no host check of the result (it captures into a CUDA graph);
    # the same LU inverse as linalg.inv.
    Kinv = torch.linalg.inv_ex(K.to(fp.F64))[0]
    ones = torch.ones_like(uv_prev[..., :1])
    x1 = torch.cat([uv_prev, ones], dim=-1).to(fp.F64) @ Kinv.T
    x2 = torch.cat([uv_cur, ones], dim=-1).to(fp.F64) @ Kinv.T
    return x1, x2


def _epipolar64(M, K, uv_prev, uv_cur):
    """Float64 pieces of the epipolar residual: (x1, x2, l, s = x2.l,
    ln = |l_xy|, fx)."""
    x1, x2 = normalized_tracks(K, uv_prev, uv_cur)
    M = M.to(fp.F64)
    E = se3.hat(M[:3, 3]) @ M[:3, :3]  # (3,3) essential matrix
    l = x1 @ E.T  # epipolar lines in current normalized coordinates
    ln = torch.sqrt(l[..., 0] * l[..., 0] + l[..., 1] * l[..., 1])
    s = torch.sum(x2 * l, dim=-1)
    return x1, x2, l, s, ln, K[0, 0].to(fp.F64)


def epipolar(M: torch.Tensor, K: torch.Tensor, uv_prev: torch.Tensor,
             uv_cur: torch.Tensor, valid: torch.Tensor,
             min_baseline: float = MIN_BASELINE):
    """Point-to-epipolar-line residual (pixels) of tracks without depth.

    ``M = [R|t]`` maps previous-camera coordinates into the current camera;
    with E = [t]x R and l = E x1, r = fx (x2 . l) / |l_xy|.  Masked when the
    baseline vanishes.  Computed in float64 (K^-1 included) and rounded
    once.  Returns (r (K,), ok (K,)).
    """
    _, _, _, s, ln, fx = _epipolar64(M, K, uv_prev, uv_cur)
    ok = valid & (fp.norm3(M[:3, 3]) > min_baseline) & (ln > 1e-8)
    r = (fx * s / torch.clamp(ln, min=1e-8)).to(uv_prev.dtype)
    return torch.where(ok, r, 0.0), ok


def epipolar_jacobian(A: torch.Tensor, T_velo_cam: torch.Tensor,
                      K: torch.Tensor, uv_prev: torch.Tensor,
                      uv_cur: torch.Tensor, ok: torch.Tensor):
    """(K, 6) derivative of :func:`epipolar`'s residual wrt a left
    perturbation xi = (rho, phi) of the solved pose T, where
    ``M(xi) = A exp(-xi) T_velo_cam`` and ``A = T_cam_velo T^-1``.

    The reference takes this with ``jax.jacfwd``; here it is analytic, in
    float64: dM_k = -A G_k T_velo_cam with G_k the k-th se(3) generator,
    dE_k = [dt_k]x R + [t]x dR_k, dl_k = dE_k x1, and
    dr_k = fx ((x2 . dl_k) - s (l_xy . dl_k,xy) / ln^2) / ln.  Rows where
    ``ok`` is False are zero.
    """
    A = A.to(fp.F64)
    Tvc = T_velo_cam.to(fp.F64)
    M = A @ Tvc
    x1, x2, l, s, ln, fx = _epipolar64(M, K, uv_prev, uv_cur)
    R, t = M[:3, :3], M[:3, 3]
    G = torch.zeros((6, 4, 4), dtype=fp.F64, device=A.device)
    G[:3, :3, 3] = torch.eye(3, dtype=fp.F64, device=A.device)
    G[3:, :3, :3] = se3.hat(torch.eye(3, dtype=fp.F64, device=A.device))
    dM = -(A @ G @ Tvc)  # (6, 4, 4)
    dE = (se3.hat(dM[:, :3, 3]) @ R + se3.hat(t) @ dM[:, :3, :3])  # (6,3,3)
    dl = torch.einsum("mij,kj->kmi", dE, x1)  # (K, 6, 3)
    ds = torch.einsum("ki,kmi->km", x2, dl)
    dln2 = l[:, None, 0] * dl[..., 0] + l[:, None, 1] * dl[..., 1]
    lnc = ln[:, None]
    J = fx * (ds - s[:, None] * dln2 / (lnc * lnc)) / lnc
    return torch.where(ok[:, None], J, 0.0).to(uv_prev.dtype)


def huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    ar = torch.abs(r)
    return torch.where(ar <= delta, 1.0, delta / torch.clamp(ar, min=_EPS))


def huber_cost(r: torch.Tensor, delta: float) -> torch.Tensor:
    ar = torch.abs(r)
    return torch.where(ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta))


def cauchy_weight(r: torch.Tensor, scale: float) -> torch.Tensor:
    x = fp.div(r, scale)
    return 1.0 / (1.0 + x * x)


def cauchy_cost(r: torch.Tensor, scale: float) -> torch.Tensor:
    x = fp.div(r, scale)
    return 0.5 * scale * scale * torch.log1p(x * x)


def robust_weight(r: torch.Tensor, delta: float, kind: str) -> torch.Tensor:
    if kind == "huber":
        return huber_weight(r, delta)
    if kind == "cauchy":
        return cauchy_weight(r, delta)
    raise ValueError(f"unknown robust loss {kind!r}")


def robust_cost(r: torch.Tensor, delta: float, kind: str) -> torch.Tensor:
    if kind == "huber":
        return huber_cost(r, delta)
    if kind == "cauchy":
        return cauchy_cost(r, delta)
    raise ValueError(f"unknown robust loss {kind!r}")


def _weighted_cov(pts: torch.Tensor, mask: torch.Tensor):
    """Masked centroid and covariance of (…, k, 3) neighbour sets.

    The sums run in the reference's order on the CPU: sequential over k,
    and the covariance as a multiply-add chain over k, as XLA evaluates the
    reference's einsum.  Flat synthetic ground makes the smallest eigenvalue
    exactly 0, where the eigenvalue-ratio gates of the fits hinge on these
    last-bit roundings.
    """
    k = pts.shape[-2]
    w = mask[..., None].to(pts.dtype)
    pw = pts * w
    cnt = w[..., 0, :]
    s = pw[..., 0:1, :]
    for j in range(1, k):
        cnt = cnt + w[..., j, :]
        s = s + pw[..., j:j + 1, :]
    cnt = torch.clamp(cnt, min=1.0)
    mu = s / cnt[..., None, :]
    d = (pts - mu) * w
    cov = d[..., 0, :, None] * d[..., 0, None, :]
    for j in range(1, k):
        cov = fp.fma(d[..., j, :, None], d[..., j, None, :], cov)
    return mu, cov / cnt[..., :, None]


def fit_line_eig(pts: torch.Tensor, mask: torch.Tensor):
    """PCA line over (…, k, 3) neighbour sets -> (centroid, direction, ok,
    quality); ok needs the top eigenvalue >= 3x the second."""
    mu, cov = _weighted_cov(pts, mask)
    evals, evecs = sym_eig3x3(cov)
    direction = evecs[..., :, 2]
    ok = (evals[..., 2] > 3.0 * evals[..., 1]) & (torch.sum(mask, dim=-1) >= 3)
    quality = torch.clamp(
        1.0 - 3.0 * evals[..., 1] / torch.clamp(evals[..., 2], min=_EPS),
        0.0, 1.0)
    return mu[..., 0, :], direction, ok, quality


def fit_plane_eig(pts: torch.Tensor, mask: torch.Tensor,
                  max_pt_dist: float = 0.2):
    """PCA plane over (…, k, 3) neighbour sets with flatness gates ->
    (normal, offset, ok, quality)."""
    mu, cov = _weighted_cov(pts, mask)
    evals, evecs = sym_eig3x3(cov)
    n = evecs[..., :, 0]
    d0 = -fp.dot3(n, mu[..., 0, :])
    pt_dist = torch.abs(fp.dot3(pts, n[..., None, :]) + d0[..., None])
    ok = (
        (evals[..., 1] > 3.0 * evals[..., 0])
        & (torch.sum(mask, dim=-1) >= 3)
        & torch.all(torch.where(mask, pt_dist, 0.0) < max_pt_dist, dim=-1)
    )
    quality = torch.clamp(
        1.0 - 3.0 * evals[..., 0] / torch.clamp(evals[..., 1], min=_EPS),
        0.0, 1.0)
    return n, d0, ok, quality
