"""The yardstick of the kernels' roofline shares: the H100's published
peaks and the least time a piece of work can take on it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W power
limit): 3.35 TB/s of HBM, 67 TFLOP/s of float32 and 33.5 TFLOP/s of
float64 outside the tensor cores (132 SMs at 1.98 GHz, 128 float32 and 64
float64 fused multiply-adds a clock each; the data sheet rounds the
latter to 34).
A card set below 700 W runs slower under load; the harness reads the
card's power limit and prints it beside every roofline share.
"""
from __future__ import annotations

import shutil
import subprocess

HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
FP64_FLOP_S = 33.5e12


def least_seconds(n_bytes: float, n_ops: float) -> float:
    """The least time ``n_bytes`` of HBM traffic and ``n_ops`` float32
    operations take: the larger of the two bounds."""
    return max(n_bytes / HBM_BYTES_S, n_ops / FP32_FLOP_S)


def least_seconds_f64(n_bytes: float, n_f64_ops: float) -> float:
    """The least time ``n_bytes`` of HBM traffic and ``n_f64_ops`` float64
    operations take: the larger of the two bounds."""
    return max(n_bytes / HBM_BYTES_S, n_f64_ops / FP64_FLOP_S)


def power_limit_w():
    """The card's power limit in W from ``nvidia-smi``, or None where it
    cannot be read."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        done = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(done.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        return None
