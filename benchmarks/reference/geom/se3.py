"""SE(3) Lie-group utilities on tensors (port of ``velo_tpu/geom/se3.py``).

Poses are (..., 4, 4) homogeneous float32 matrices; tangent vectors are
6-vectors ``xi = (rho, phi)``, translation first.  Every function broadcasts
over leading batch dimensions.  Small-angle branches are selected with
``torch.where`` on safe denominators, as in the reference, so that no branch
ever synchronises with the host.  Products, reductions and trigonometry go
through ``velo_tpu_torch.fp`` so that they round alike on CPU and GPU.
"""
from __future__ import annotations

import torch

from benchmarks.reference import fp

_EPS = 1e-6


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector; batched over leading dims."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: the 3-vector of a skew-symmetric matrix."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta_sq: torch.Tensor):
    """A = sin(t)/t, B = (1-cos(t))/t^2, C = (t-sin(t))/t^3, safely."""
    theta = fp.sqrt(torch.clamp(theta_sq, min=1e-24))
    small = theta_sq < _EPS
    safe_t = torch.where(small, 1.0, theta)
    sin_t, cos_t = fp.sin(safe_t), fp.cos(safe_t)
    A = torch.where(small, 1.0 - fp.div(theta_sq, 6.0), sin_t / safe_t)
    B = torch.where(small, 0.5 - fp.div(theta_sq, 24.0),
                    (1.0 - cos_t) / (safe_t * safe_t))
    C = torch.where(small, 1.0 / 6.0 - fp.div(theta_sq, 120.0),
                    (safe_t - sin_t) / (safe_t * safe_t * safe_t))
    return A, B, C


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def exp_so3(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: axis-angle 3-vector -> rotation matrix. Batched."""
    theta_sq = fp.dot3(phi, phi)
    A, B, _ = _sinc_coeffs(theta_sq)
    K = hat(phi)
    KK = fp.matmul(K, K)
    return _eye3(K) + A[..., None, None] * K + B[..., None, None] * KK


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), Shepperd's method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def _safe_sqrt(x):
        return fp.sqrt(torch.clamp(x, min=1e-12))

    sw = 2.0 * _safe_sqrt(qw2)
    quat_w = torch.stack(
        [0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw],
        dim=-1)
    sx = 2.0 * _safe_sqrt(qx2)
    quat_x = torch.stack(
        [(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx],
        dim=-1)
    sy = 2.0 * _safe_sqrt(qy2)
    quat_y = torch.stack(
        [(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy],
        dim=-1)
    sz = 2.0 * _safe_sqrt(qz2)
    quat_z = torch.stack(
        [(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz],
        dim=-1)

    idx = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    q = torch.where(
        (idx == 0)[..., None], quat_w,
        torch.where((idx == 1)[..., None], quat_x,
                    torch.where((idx == 2)[..., None], quat_y, quat_z)))
    q = q / fp.norm(q)[..., None]
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle 3-vector, robust for all angles."""
    q = rotmat_to_quat(R)
    qw = q[..., 0]
    qv = q[..., 1:]
    n = fp.norm3(qv)
    small = n < _EPS
    safe_n = torch.where(small, 1.0, n)
    theta = 2.0 * fp.atan2(n, qw)
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=0.5), theta / safe_n)
    return scale[..., None] * qv


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V such that exp_se3 translation t = V @ rho."""
    theta_sq = fp.dot3(phi, phi)
    _, B, C = _sinc_coeffs(theta_sq)
    K = hat(phi)
    KK = fp.matmul(K, K)
    return _eye3(K) + B[..., None, None] * K + C[..., None, None] * KK


def _left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta_sq = fp.dot3(phi, phi)
    theta = fp.sqrt(torch.clamp(theta_sq, min=1e-24))
    small = theta_sq < _EPS
    safe_t = torch.where(small, 1.0, theta)
    cot_term = (1.0 + fp.cos(safe_t)) / (2.0 * safe_t * fp.sin(safe_t))
    D = torch.where(small, 1.0 / 12.0 + fp.div(theta_sq, 720.0),
                    1.0 / (safe_t * safe_t) - cot_term)
    K = hat(phi)
    KK = fp.matmul(K, K)
    return _eye3(K) - 0.5 * K + D[..., None, None] * KK


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return fp.matmul(M, v[..., None])[..., 0]


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) tangent (rho, phi) -> 4x4 homogeneous transform. Batched."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return from_rt(exp_so3(phi), _matvec(_left_jacobian(phi), rho))


def log(T: torch.Tensor) -> torch.Tensor:
    """4x4 homogeneous transform -> se(3) tangent (rho, phi). Batched."""
    R, t = to_rt(T)
    phi = log_so3(R)
    rho = _matvec(_left_jacobian_inv(phi), t)
    return torch.cat([rho, phi], dim=-1)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble a 4x4 transform from rotation (…,3,3) and translation (…,3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = fp.const([0.0, 0.0, 0.0, 1.0], R.dtype,
                      R.device).expand(batch + (4,))[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def to_rt(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def inv(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform (exact, no linear solve)."""
    R, t = to_rt(T)
    Rt = R.transpose(-1, -2)
    return from_rt(Rt, -_matvec(Rt, t))


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B of (…,4,4) transforms."""
    return fp.matmul(A, B)


def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (…,4,4) transform to (…,N,3) points -> (…,N,3)."""
    R, t = to_rt(T)
    out = torch.matmul(pts.to(fp.F64), R.transpose(-1, -2).to(fp.F64))
    return (out + t[..., None, :].to(fp.F64)).to(pts.dtype)


def apply_one(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (…,4,4) transforms to (…,3) points, batch dims aligned."""
    R, t = to_rt(T)
    out = torch.matmul(R.to(fp.F64), p.to(fp.F64)[..., None])[..., 0]
    return (out + t.to(fp.F64)).to(p.dtype)


def interp(T: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Geodesic interpolation exp(s * log(T)); s broadcasts over batch dims."""
    return exp(s[..., None] * log(T))
