"""Closed-form batched 3x3 symmetric eigendecomposition
(port of ``velo_tpu/geom/linalg.py``).

``torch.linalg.eigh`` on thousands of tiny matrices is a batched iterative
solver; the trigonometric closed form is a handful of element-wise passes
and matches the reference's eigenvector conventions.
"""
from __future__ import annotations

import math

import torch

from benchmarks.reference import fp


def sym_eig3x3(A: torch.Tensor):
    """Eigen-decomposition of symmetric (…, 3, 3) matrices.

    Returns (evals, evecs): eigenvalues ascending and ``evecs[..., :, i]``
    the unit eigenvector of ``evals[..., i]`` (``eigh``'s convention).
    """
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = fp.div(a00 + a11 + a22, 3.0)
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = fp.sqrt(torch.clamp(fp.div(p2, 6.0), min=1e-30))

    b00 = (a00 - q) / p
    b11 = (a11 - q) / p
    b22 = (a22 - q) / p
    b01 = a01 / p
    b02 = a02 / p
    b12 = a12 / p
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detB * 0.5, -1.0, 1.0)
    phi = fp.div(fp.arccos(r), 3.0)

    e_hi = q + 2.0 * p * fp.cos(phi)
    e_lo = q + 2.0 * p * fp.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    iso = p2 < 1e-20
    e_hi = torch.where(iso, q, e_hi)
    e_mid = torch.where(iso, q, e_mid)
    e_lo = torch.where(iso, q, e_lo)
    evals = torch.stack([e_lo, e_mid, e_hi], dim=-1)

    def eigvec(lam):
        r0 = torch.stack([a00 - lam, a01, a02], dim=-1)
        r1 = torch.stack([a01, a11 - lam, a12], dim=-1)
        r2 = torch.stack([a02, a12, a22 - lam], dim=-1)
        c01 = fp.cross3(r0, r1)
        c02 = fp.cross3(r0, r2)
        c12 = fp.cross3(r1, r2)
        n01 = fp.dot3(c01, c01)
        n02 = fp.dot3(c02, c02)
        n12 = fp.dot3(c12, c12)
        best = torch.where(
            ((n01 >= n02) & (n01 >= n12))[..., None],
            c01,
            torch.where((n02 >= n12)[..., None], c02, c12),
        )
        nrm = fp.norm3(best)[..., None]
        fallback = fp.const([1.0, 0.0, 0.0], A.dtype,
                            A.device).expand(best.shape)
        return torch.where(nrm > 1e-12, best / torch.clamp(nrm, min=1e-12),
                           fallback)

    v_lo = eigvec(e_lo)
    v_hi = eigvec(e_hi)
    v_mid = fp.cross3(v_hi, v_lo)
    v_mid = v_mid / torch.clamp(fp.norm3(v_mid)[..., None], min=1e-12)
    evecs = torch.stack([v_lo, v_mid, v_hi], dim=-1)
    return evals, evecs
