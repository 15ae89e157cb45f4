"""float32 arithmetic that rounds the same on the CPU and on the GPU.

PyTorch's CPU and CUDA builds agree bit for bit on element-wise +, -, *
and division by a tensor (IEEE, one rounding each), but not on the rest:
float32 sqrt, sin, cos, atan2 and arccos are not rounded alike; CUDA
divides by a Python number as a multiply by its reciprocal; matrix
products and reductions sum in other orders, with fused multiply-adds on
the GPU; Cholesky comes from different libraries.  The odometry step feeds such
last bits into discrete decisions (feature picks at curvature near-ties,
eigenvalue-ratio gates on flat ground, LM accept/reject at convergence), so
two devices running the same frames drift apart.

The helpers below keep float32 values and shapes at every interface but
compute each such operation in float64 and round once to float32.  A
float64 result is within a few float64 ulps on either device, so the
float32 rounding agrees unless it lands within ~2^-28 of a rounding
midpoint.  The 3-vector helpers also reproduce how XLA evaluates the
reference on the CPU: ``jnp.cross`` as ``fma(a1, b2, -(a2 * b1))`` and
sums of products over the last axis as a multiply-add chain in index
order.
"""
from __future__ import annotations

import torch

F64 = torch.float64


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded: the float64 root of a float32 value rounds to
    the float32 root.  CUDA's float32 sqrt differs on ~0.6 % of inputs."""
    return torch.sqrt(x.to(F64)).to(x.dtype)


def sin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x.to(F64)).to(x.dtype)


def cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x.to(F64)).to(x.dtype)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c for a Python number c, correctly rounded on both devices:
    CUDA divides by a host scalar as a multiply by its rounded reciprocal,
    but by a device tensor exactly."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def const(values, dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)`` for a flat
    sequence of Python numbers, made on the device by one fill per run of
    equal values: no host-to-device copy, so it captures into a CUDA graph.
    Each value rounds to ``dtype`` as ``torch.tensor`` rounds it."""
    values = [float(v) if dtype.is_floating_point else int(v)
              for v in values]
    out = torch.empty(len(values), dtype=dtype, device=device)
    start = 0
    for i in range(1, len(values) + 1):
        if i == len(values) or values[i] != values[start]:
            out[start:i].fill_(values[start])
            start = i
    return out


def arccos(x: torch.Tensor) -> torch.Tensor:
    return torch.arccos(x.to(F64)).to(x.dtype)


def arcsin(x: torch.Tensor) -> torch.Tensor:
    return torch.arcsin(x.to(F64)).to(x.dtype)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.atan2(y.to(F64), x.to(F64)).to(y.dtype)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c with one rounding: the float64 product of two float32 values
    is exact, so only the sum rounds (then to float32; the two roundings
    differ from one only within 2^-29 of a float32 midpoint)."""
    return (a.to(F64) * b.to(F64) + c.to(F64)).to(a.dtype)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (size 3) of a*b: fma(a2, b2, fma(a1, b1, a0 b0))."""
    acc = a[..., 0] * b[..., 0]
    acc = fma(a[..., 1], b[..., 1], acc)
    return fma(a[..., 2], b[..., 2], acc)


def norm3(a: torch.Tensor) -> torch.Tensor:
    return sqrt(dot3(a, a))


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([fma(a1, b2, -(a2 * b1)), fma(a2, b0, -(a0 * b2)),
                        fma(a0, b1, -(a1 * b0))], dim=-1)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.to(F64), b.to(F64)).to(a.dtype)


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *(o.to(F64) for o in ops)).to(ops[0].dtype)


def sum(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    if dim is None:
        return torch.sum(x.to(F64)).to(x.dtype)
    return torch.sum(x.to(F64), dim=dim, keepdim=keepdim).to(x.dtype)


def norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, of any length."""
    return torch.sqrt(torch.sum(x.to(F64) * x.to(F64), dim=-1)).to(x.dtype)
