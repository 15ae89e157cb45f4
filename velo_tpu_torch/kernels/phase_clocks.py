"""Where a ``dist_topk`` launch spends its cycles, read from inside it.

    python -m velo_tpu_torch.kernels.phase_clocks

Builds ``csrc/dist_topk.cu`` with ``-DDIST_TOPK_PHASE_CLOCKS``: thread 0 of
each block then records ``clock64()`` at the start, after the fold, after
the first column scan, after the k extraction rounds and after the index
recomputation.  Runs the four path shapes of ``chip_smoke.py`` and prints,
per shape, the median and the maximum over blocks of the cycles of each
phase (SM clock; the recording itself costs a little, so read them beside
each other, not as the kernel's time).
"""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from velo_tpu_torch.kernels import _build
from velo_tpu_torch.kernels import dist_topk as dtk
from velo_tpu_torch.kernels.compare_previous import K, PATH_SHAPES

PHASES = ("fold", "scan", "rounds", "index")


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    lib = _build.load_variant(_build.CSRC / "dist_topk.cu", "dist_topk_clocks",
                              ["-DDIST_TOPK_PHASE_CLOCKS"])
    launch = dtk._kernel_fn()  # sets the argument types on the shipped build
    lib.dist_topk_launch.argtypes = launch.argtypes
    lib.dist_topk_launch.restype = launch.restype
    lib.dist_topk_phase_clocks.argtypes = [ctypes.c_void_p]
    dtk._fn = lib.dist_topk_launch
    rng = np.random.default_rng(0)
    for q, n, bf in PATH_SHAPES:
        t = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
        tm = rng.random(n) > 0.1
        qs = (t[rng.integers(0, n, q)]
              + rng.normal(0, 0.5, (q, 3))).astype(np.float32)
        tt, tmt, qt = (torch.as_tensor(x, device=dev) for x in (t, tm, qs))
        for _ in range(3):
            dtk._launch(tt[None], tmt[None], qt[None], K, bf)
        torch.cuda.synchronize()
        clocks = np.zeros((1024, 5), np.int64)
        err = lib.dist_topk_phase_clocks(clocks.ctypes.data)
        if err:
            raise RuntimeError(f"reading the clocks: CUDA error {err}")
        g = dtk.launch_geometry(q, n, bf, K)
        d = np.diff(clocks[:min(g.blocks, 1024)], axis=1)
        print(f"Q={q} N={n} B={bf} ({g.blocks} blocks of {g.tq} queries): "
              + ", ".join(f"{name} {int(np.median(d[:, i]))} (max "
                          f"{int(d[:, i].max())})"
                          for i, name in enumerate(PHASES))
              + f"; whole block {int(np.median(d.sum(1)))} cycles",
              flush=True)


if __name__ == "__main__":
    main()
