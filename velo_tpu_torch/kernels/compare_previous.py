"""Time this tree's kernels against an earlier design's, in one process on
one card, in turns (old, new, new, old).

    mkdir -p _checkout/old
    git show <rev>:velo_tpu_torch/csrc/dist_topk.cu > _checkout/old/dist_topk.cu
    git show <rev>:velo_tpu_torch/csrc/klt_l0.cu > _checkout/old/klt_l0.cu
    python -m velo_tpu_torch.kernels.compare_previous --old _checkout/old

The old sources must have the C interface of the first design (revision
a471739): ``dist_topk_launch(q_aug, qp, m, n, tn, nbt, k, out_s, out_i,
stream)`` on the (4, N) ``m`` and the padded ``q_aug`` that the plain
version's ``_prepare`` makes, with ``_finish`` after it, and
``klt_l0_launch(prev, cur, H, W, uv_prev, uv_cur, K, iters, uv_out,
ok_out, stream)``, unbatched (revisions d8cb0d5 to fb6c505); this tree's
kernels run as a batch of one.  Shapes and inputs are those of
``chip_smoke.py``'s kernel checks.  Old and new results must be bitwise
equal.  Prints one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

import velo_tpu_torch as vt
from velo_tpu_torch.kernels import _build
from velo_tpu_torch.kernels import dist_topk as dtk
from velo_tpu_torch.kernels import klt_l0 as kl
from velo_tpu_torch.kernels._timing import graph_ms, median_ms
from velo_tpu_torch.vision import corners

PATH_SHAPES = [(1024, 3072, 4), (2048, 6144, 4), (1024, 16384, 32),
               (2048, 32768, 32)]
K = 16


def _build_old(old_dir: Path, name: str) -> ctypes.CDLL:
    lib = _build.load_variant(old_dir / f"{name}.cu", f"old_{name}")
    print(f"old {name}:", [ln.strip() for ln in
                           _build.build_logs[f"old_{name}"].split("\n")
                           if "registers" in ln or "spill" in ln], flush=True)
    return lib


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _in_turns(old, new, timer=median_ms):
    """(old ms, new ms), each the mean of two medians taken old, new, new,
    old.  ``median_ms`` times what the caller sees (the host's dispatch
    included where it is the slower side), ``graph_ms`` the card alone."""
    o1, n1, n2, o2 = timer(old), timer(new), timer(new), timer(old)
    return (o1 + o2) / 2, (n1 + n2) / 2


def compare_dist_topk(old_dir: Path, dev) -> list:
    fn = _build_old(old_dir, "dist_topk").dist_topk_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, i, i, i, i, p, p, p]
    fn.restype = ctypes.c_int

    def old_select(q_aug, m, tn, nbt):
        qp = q_aug.shape[0]
        s = torch.empty((qp, K), dtype=torch.float32, device=dev)
        ix = torch.empty((qp, K), dtype=torch.int32, device=dev)
        err = fn(q_aug.data_ptr(), qp, m.data_ptr(), m.shape[1], tn, nbt, K,
                 s.data_ptr(), ix.data_ptr(), _stream(dev))
        if err:
            raise RuntimeError(f"old dist_topk: CUDA error {err}")
        return s, ix

    def old_wrapper(t, tm, q, bf):
        m, q_aug, tn, nbt = dtk._prepare(t, tm, q, K, bf)
        return dtk._finish(q, *old_select(q_aug, m, tn, nbt))

    rng = np.random.default_rng(0)
    rows = []
    for q, n, bf in PATH_SHAPES:
        t = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
        tm = rng.random(n) > 0.1
        qs = (t[rng.integers(0, n, q)]
              + rng.normal(0, 0.5, (q, 3))).astype(np.float32)
        tt, tmt, qt = (torch.as_tensor(x, device=dev) for x in (t, tm, qs))
        a, b = old_wrapper(tt, tmt, qt, bf), dtk.dist_topk(tt, tmt, qt, K, bf)
        torch.cuda.synchronize()
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"old != new at {(q, n, bf)}")
        m, q_aug, tn, nbt = dtk._prepare(tt, tmt, qt, K, bf)
        old_w, new_w = _in_turns(lambda: old_wrapper(tt, tmt, qt, bf),
                                 lambda: dtk.dist_topk(tt, tmt, qt, K, bf))
        old_k, new_k = _in_turns(lambda: old_select(q_aug, m, tn, nbt),
                                 lambda: dtk._launch(tt[None], tmt[None],
                                                     qt[None], K, bf),
                                 graph_ms)
        lib = median_ms(lambda: torch.topk(torch.cdist(qt, tt), K, dim=1,
                                           largest=False))
        rows.append({"q": q, "n": n, "bin_factor": bf,
                     "old_wrapper_ms": old_w, "new_wrapper_ms": new_w,
                     "old_kernel_ms": old_k, "new_kernel_ms": new_k,
                     "library_ms": lib})
        print("dist_topk", rows[-1], flush=True)
    return rows


def compare_klt_l0(old_dir: Path, dev) -> list:
    fn = _build_old(old_dir, "klt_l0").klt_l0_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, p, p, i, i, p, p, p]
    fn.restype = ctypes.c_int

    def old_launch(a, b, up, uc, iters):
        H, W = a.shape
        k = up.shape[0]
        uv = torch.empty((k, 2), dtype=torch.float32, device=dev)
        ok = torch.empty((k,), dtype=torch.bool, device=dev)
        err = fn(a.data_ptr(), b.data_ptr(), H, W, up.data_ptr(),
                 uc.data_ptr(), k, iters, uv.data_ptr(), ok.data_ptr(),
                 _stream(dev))
        if err:
            raise RuntimeError(f"old klt_l0: CUDA error {err}")
        return uv, ok

    fx = vt.fixtures.make_fixture(n_frames=2, n_rings=64, n_azimuth=2048,
                                  height=192, width=640, seed=0)
    vc = vt.config.VisionConfig(height=192, width=640, klt_impl="pallas")
    im0 = torch.as_tensor(fx.images[0], device=dev)
    im1 = torch.as_tensor(fx.images[1], device=dev)
    uv0 = corners.detect(im0, vc).uv.contiguous()
    fwd, _ = kl.track_level0_reference(im0, im1, uv0, uv0, vc, vc.klt_iters)
    rows = []
    for name, args in {"forward": (im0, im1, uv0, uv0, vc.klt_iters),
                       "backward": (im1, im0, fwd, uv0,
                                    vc.klt_iters_fb)}.items():
        batch1 = [x[None] for x in args[:4]] + [args[4]]
        a, b = old_launch(*args), kl._launch(*batch1)
        torch.cuda.synchronize()
        if not (torch.equal(a[0], b[0][0]) and torch.equal(a[1], b[1][0])):
            raise AssertionError(f"klt_l0 {name}: old != new")
        old_k, new_k = _in_turns(lambda: old_launch(*args),
                                 lambda: kl._launch(*batch1), graph_ms)
        rows.append({"call": name, "iters": args[4], "old_kernel_ms": old_k,
                     "new_kernel_ms": new_k, "ok": int(b[1].sum())})
        print("klt_l0", rows[-1], flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory with the old dist_topk.cu and klt_l0.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build_all(["dist_topk", "klt_l0"])
    for name in ("dist_topk", "klt_l0"):
        print(f"new {name}:", [ln.strip() for ln in
                               _build.build_logs.get(name, "").split("\n")
                               if "registers" in ln or "spill" in ln
                               or "smem" in ln], flush=True)
    result = {"card": smi, "dist_topk": compare_dist_topk(args.old, dev),
              "klt_l0": compare_klt_l0(args.old, dev)}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
