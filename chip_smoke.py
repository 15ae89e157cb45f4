"""GPU smoke test of the PyTorch port: build, check and run it on one card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. card check: a CUDA device must be present; prints its name and power
   limit as nvidia-smi reports them;
2. build: compiles ``velo_tpu_torch/csrc/dist_topk.cu`` and ``klt_l0.cu``
   with nvcc (sm_90a), one process each, started together;
3. fixture: one full-scale drive (64 x 2048 LiDAR, 192 x 640 images,
   8 frames, seed 0), host-pre-binned once and shared by the phases below;
4. kernel checks at the shapes of the odometry path, each kernel against
   its plain PyTorch version on the card (bitwise), with CUDA-event times
   of the wrapper, the plain version and, where one exists, a PyTorch
   library call for the same function, and the kernel alone replayed from
   a CUDA graph (no host between launches):
   ``dist_topk`` at its four calls per frame and at the smoother's two
   window-map shapes (plus recall against an exact top-16, the CUDA
   launches one wrapper call makes, and a check that the wrapper is no
   slower than the library call), ``klt_l0`` on 256 corners
   of frame 0 tracked into frame 1 (8 iterations) and back (4 iterations);
   then edge cases of both, bitwise too: fewer than k live bins,
   duplicated targets, Q = 1000; NaN, border and textureless tracks;
5. fused pipeline: the 8 frames through ``pipeline.odometry.run_sequence``
   at the bench's fused configuration with ``klt_impl="pallas"``; it must
   launch ``klt_l0`` 2 and ``dist_topk`` 4 times per frame, keep the whole
   carry on the card, stay within the pose gates against ground truth,
   agree with the port's own CPU run of the same frames, and a short
   profile reads the card's busy share;
6. the same fused run with the shipped ``klt_impl="auto"`` (level 0 on the
   gather sampler, no ``klt_l0`` launch): ground truth, frames/s and
   profile beside the kernel's, to decide which should be the default;
7. LiDAR-only pipeline: the same frames without images, the checks of the
   first slice (4 ``dist_topk`` launches per frame, ground truth, CPU);
8. export: ``io.fake_kitti.export`` writes 8 full-scale frames (HDL-64E
   beam table, sweep start at the rear) as a KITTI sequence directory; the
   scans and PNGs read back equal to what was written;
9. cli-kitti: ``velo_tpu_torch.cli.main`` in process on that directory,
   fused with ``klt_impl=pallas``, with a checkpoint every 4 frames and the
   smoother (window 8, 2 passes): launch counts (forward 4 ``dist_topk``
   and 2 ``klt_l0`` per frame, smoother 2 ``dist_topk`` per frame and pass,
   at the window-map shapes), relative motion within 10 cm of ground truth
   in the median before and after smoothing, an interrupted run resumed to
   the bitwise forward trajectory, the smoother called as a library pass by
   pass (timed; frame 0 kept; equal to the command line's file), and the
   forward run and one smoother pass against ``--device cpu``;
10. cli-variants: ``--synthetic --rings 64 --azimuth 2048 --no-vision`` over
    4 frames, plain, ``--fast`` and ``--no-prebin``: ground truth, card
    against CPU, raw-scan against pre-binned.

Prints a JSON line of pipeline results, one of per-kernel results, then as
its last line ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# (queries, targets, bin_factor) of the four dist_topk calls of one frame at
# 64 x 2048: edge and planar queries against the previous scan's targets,
# then against the edge and planar local maps.
PATH_SHAPES = [(1024, 3072, 4), (2048, 6144, 4), (1024, 16384, 32),
               (2048, 32768, 32)]
# The smoother's two calls per frame and pass: edge and planar queries
# against the window map of 2 * 8 + 1 frames' targets (the centre frame
# masked out), 17 and 34 tiles of 96 bins.
SMOOTH_WINDOW, SMOOTH_PASSES = 8, 2  # the command line's defaults
SMOOTH_SHAPES = [(1024, (2 * SMOOTH_WINDOW + 1) * 3072, 32),
                 (2048, (2 * SMOOTH_WINDOW + 1) * 6144, 32)]
K = 16
N_FRAMES = 8
N_VARIANT_FRAMES = 4
GATE_REL_M = 0.10  # median relative per-frame motion vs ground truth (m)
KITTI_SET = "v:klt_impl=pallas"  # --set of the command line's KITTI run
SEED = 0
RINGS, AZ, IMG_H, IMG_W = 64, 2048, 192, 640
GATE_GT_M = 0.25  # full-scale pose error vs ground truth (m)
GATE_GT_DEG = {"lidar": 1.0, "fused": 1.5, "fused-gather": 1.5}  # (deg)
GATE_CPU_M, GATE_CPU_DEG = 0.05, 0.1  # card vs the port's own CPU run
# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM rate, float32 outside
# the tensor cores.
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
# klt_l0 arithmetic, counted from its plain version: a template (a track
# whose support lies inside the image) costs three
# 15x15 bilinear patches (16x15 row lerps + 15x15 column lerps, 3 ops
# each, ~1397), Scharr gx and gy on the 16x16 support (9 ops per value,
# 4608) and three 225-term products and sums (1347); a Gauss-Newton step
# one patch, the error (225) and two 225-term product sums (898), ~2528.
KLT_TEMPLATE_OPS = 3 * 1397 + 4608 + 1347
KLT_STEP_OPS = 1397 + 225 + 898 + 8
DIST_TOPK_OPS_PER_PAIR = 7  # 4 products and 3 sums of s per query-target
# What the instruction rate allows dist_topk, beside the bound: the bitwise
# contract forbids fusing a product with its sum, so a query-target pair is
# 3 products, 3 sums (the fourth product is by 1) and a minimum at half
# rate, 8 lane slots on 132 SMs x 128 float32 lanes at 1.98 GHz.
DIST_TOPK_SLOTS_PER_PAIR = 8
FP32_LANE_SLOTS_S = 132 * 128 * 1.98e9


def card_check() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test runs on the card")
    import velo_tpu_torch  # noqa: F401  (sets full-fp32 matmuls)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return smi


def build() -> None:
    from velo_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all(["dist_topk", "klt_l0"])
    for name in ("dist_topk", "klt_l0"):
        _build.load(name)
        regs = [ln.strip() for ln in _build.build_logs.get(name, "").split(
            "\n") if "registers" in ln or "spill" in ln]
        print(f"build: {name} nvcc "
              f"{_build.build_seconds.get(name, 0.0):.2f} s; {regs}",
              flush=True)
    print(f"build: both kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)


def memoize_fixtures() -> None:
    """The drive simulator is a pure function of its arguments and takes
    10-40 s at full scale; the command line simulates anew on every call
    and the phases below ask for the same drives several times."""
    from velo_tpu_torch.io import fixtures

    make, cache = fixtures.make_fixture, {}

    def make_fixture(**kw):
        key = tuple(sorted(
            (k, v.tobytes() if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()))
        if key not in cache:
            cache[key] = make(**kw)
        return cache[key]

    fixtures.make_fixture = make_fixture


def make_frames():
    import velo_tpu_torch as vt
    from velo_tpu_torch.lidar import rangeimage as ri_mod

    t0 = time.perf_counter()
    fx = vt.fixtures.make_fixture(n_frames=N_FRAMES, n_rings=RINGS,
                                  n_azimuth=AZ, height=IMG_H, width=IMG_W,
                                  seed=SEED)
    lcfg = vt.config.LidarConfig(n_rings=RINGS, n_azimuth=AZ)
    grids = [ri_mod.bin_scan_host(s, lcfg) for s in fx.scans]
    print(f"fixture: {N_FRAMES} frames with images in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return fx, grids


def _bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / FP32_FLOP_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _cuda_launches(fn):
    """Names of the card kernels (and copies) one call of ``fn`` makes."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.name for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


def _dist_topk_problem(rng, q, n, masked=0.1):
    t = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    tm = rng.random(n) >= masked
    qs = (t[rng.integers(0, n, q)]
          + rng.normal(0, 0.5, (q, 3))).astype(np.float32)
    return t, tm, qs


def _dist_topk_edge_cases(rng):
    """name -> (targets, mask, queries, bin_factor), each at N = 3072."""
    n, bf = 3072, 4
    cases = {}
    # Fewer than k live bins: the trailing rounds repeat one bin.
    t, tm, qs = _dist_topk_problem(rng, 1024, n)
    tm = np.zeros(n, bool)
    tm[rng.choice(n, 10, replace=False)] = True
    cases["few_live"] = (t, tm, qs, bf)
    # Exact ties inside a bin (j and j + 768) and across two bins.
    t, tm, qs = _dist_topk_problem(rng, 1024, n, masked=0.0)
    t[1:768:2] = t[0:767:2]
    t[768:1536] = t[0:768]
    cases["duplicates"] = (t, tm, t[rng.integers(0, 1536, 1024)] + np.float32(
        0.25), bf)
    cases["q1000"] = _dist_topk_problem(rng, 1000, n) + (bf,)
    return cases


def dist_topk_check(dev) -> dict:
    from velo_tpu_torch.kernels import dist_topk as dtk
    from velo_tpu_torch.kernels._timing import graph_ms, median_ms
    from velo_tpu_torch.kernels.dist_topk import dist_topk, dist_topk_reference

    rng = np.random.default_rng(SEED)
    per_shape, max_err = [], 0.0
    for q, n, bf in PATH_SHAPES + SMOOTH_SHAPES:
        t, tm, qs = _dist_topk_problem(rng, q, n)
        tt, tmt, qt = (torch.as_tensor(x, device=dev) for x in (t, tm, qs))
        d2, idx = dist_topk(tt, tmt, qt, k=K, bin_factor=bf)
        rd2, ridx = dist_topk_reference(tt, tmt, qt, k=K, bin_factor=bf)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ridx) and torch.equal(d2, rd2)):
            raise AssertionError(
                f"kernel != plain at {(q, n, bf)}: idx equal on "
                f"{(idx == ridx).float().mean().item():.6f}, max |d2 diff| "
                f"{(d2 - rd2).abs().max().item()}")
        max_err = max(max_err, (d2 - rd2).abs().max().item())

        # Exact top-16 in float64 on the card.
        t64, q64 = tt.double(), qt.double()
        D = ((q64[:, None, :] - t64[None, :, :]) ** 2).sum(-1)
        D[:, ~tmt] = torch.inf
        exact = torch.topk(D, K, dim=1, largest=False).indices
        hits = (idx.long()[:, :, None] == exact[:, None, :]).any(-1)
        recall = hits.float().mean().item()
        nearest = (idx[:, 0].long() == exact[:, 0]).float().mean().item()
        del t64, q64, D, exact, hits  # up to 1.7 GB each at the window map
        if not (recall > 0.97 and nearest > 0.995):
            raise AssertionError(
                f"recall {recall:.4f} / nearest {nearest:.4f} at {(q, n, bf)}")

        def wrapper():
            return dist_topk(tt, tmt, qt, k=K, bin_factor=bf)

        launched = _cuda_launches(wrapper)
        if not (1 <= len(launched) <= 2
                and all("dist_topk" in name for name in launched)):
            raise AssertionError(f"a dist_topk call launched {launched}")
        # Three medians of the wrapper: their range is the run-to-run spread
        # against which a loss to the library call is judged.
        runs = sorted(median_ms(wrapper) for _ in range(3))
        ms, spread_ms = runs[1], runs[2] - runs[0]
        plain_ms = median_ms(
            lambda: dist_topk_reference(tt, tmt, qt, k=K, bin_factor=bf))
        # The kernel alone: launches replayed from a CUDA graph.
        kernel_ms = graph_ms(lambda: dtk._launch(tt, tmt, qt, K, bf))
        # Yardstick, used nowhere in the port: exact distances + top-16.
        library_ms = median_ms(lambda: torch.topk(
            torch.cdist(qt, tt), K, dim=1, largest=False))
        bound_ms, bound_by = _bound_ms(
            n * 13 + q * 12 + q * K * 8, q * n * DIST_TOPK_OPS_PER_PAIR)
        unfused_ms = (1e3 * q * n * DIST_TOPK_SLOTS_PER_PAIR
                    / FP32_LANE_SLOTS_S)
        g = dtk.launch_geometry(q, n, bf, K)
        per_shape.append({"path": ("forward" if (q, n, bf) in PATH_SHAPES
                                   else "smoother"),
                          "query_tile": g.tq, "blocks": g.blocks,
                          "smem_bytes": g.smem_bytes,
                          "q": q, "n": n, "bin_factor": bf, "ms": ms,
                          "spread_ms": spread_ms, "unfused_ms": unfused_ms,
                          "cuda_launches_per_call": len(launched),
                          "plain_ms": plain_ms, "kernel_only_ms": kernel_ms,
                          "library_ms": library_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "recall": recall,
                          "nearest_kept": nearest})
        print(f"dist_topk Q={q} N={n} B={bf} (query tile {g.tq}, {g.blocks} "
              f"blocks, {g.smem_bytes} B shared): wrapper {ms:.4f} ms (spread "
              f"{spread_ms:.4f} ms over 3 medians; {len(launched)} CUDA "
              f"launch per call; kernel alone {kernel_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, topk(cdist) {library_ms:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}; unfused issue alone "
              f"{unfused_ms:.5f} ms), recall {recall:.4f}, nearest "
              f"{nearest:.4f}, bitwise equal", flush=True)
    # The plain version materialized Q x N (0.86 GB at the largest shape).
    del tt, tmt, qt, d2, idx, rd2, ridx
    torch.cuda.empty_cache()
    # All lines are out: now hold the wrapper against the library call.
    lost = [s for s in per_shape
            if s["ms"] - s["library_ms"] > s["spread_ms"]]
    if lost:
        raise AssertionError(
            "dist_topk wrapper slower than topk(cdist) beyond the spread at "
            f"{[(s['q'], s['n'], s['ms'], s['library_ms']) for s in lost]}")

    for name, (t, tm, qs, bf) in _dist_topk_edge_cases(rng).items():
        tt, tmt, qt = (torch.as_tensor(x, device=dev) for x in (t, tm, qs))
        d2, idx = dist_topk(tt, tmt, qt, k=K, bin_factor=bf)
        rd2, ridx = dist_topk_reference(tt, tmt, qt, k=K, bin_factor=bf)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ridx) and torch.equal(d2, rd2)):
            raise AssertionError(f"dist_topk edge case {name}: kernel != "
                                 "plain")
        repeats = int((idx[:, 1:] == idx[:, :-1]).sum())
        if name == "few_live" and not (
                repeats >= 5 * len(qs) and bool((d2[:, 10:] == 1e30).all())):
            raise AssertionError("few_live: the exhausted rounds must repeat "
                                 f"one bin at d2 = 1e30 ({repeats} repeats)")
        print(f"dist_topk edge case {name}: Q={len(qs)} N={len(t)} B={bf}, "
              f"{repeats} repeated indices, bitwise equal", flush=True)
    return {"per_shape": per_shape, "max_abs_err": max_err}


def _klt_edge_tracks(fx, dev, uv0):
    """Images with a flat patch and tracks on the contract's edges: NaN,
    infinite and far-outside positions, the last template position that
    fits the image on each side and the first that does not, a textureless
    window, a start far from the template, a start whose patch leaves the
    image, and 16 ordinary corners."""
    im0 = torch.as_tensor(fx.images[0], device=dev).clone()
    im1 = torch.as_tensor(fx.images[1], device=dev).clone()
    im0[80:112, 300:364] = 0.5
    im1[80:112, 300:364] = 0.5
    nan, inf, ym = float("nan"), float("inf"), IMG_H / 2.0
    W, H = float(IMG_W), float(IMG_H)
    edge = torch.tensor([
        [nan, nan], [nan, ym], [200.0, nan], [inf, ym], [300.0, -inf],
        [2.0, 2.0], [-5.0, -5.0], [1e9, 1e9],
        [8.0, ym], [7.99, ym], [W - 9.01, ym], [W - 9.0, ym],
        [200.5, 8.0], [200.5, 7.5], [200.5, H - 9.01], [200.5, H - 9.0],
        [332.0, ym], [420.25, ym + 3.5], [440.5, ym], [460.5, ym]],
        dtype=torch.float32, device=dev)
    uv_prev = torch.cat([edge, uv0[:16]]).contiguous()
    uv_cur = uv_prev.clone()
    uv_cur[17] += torch.tensor([30.0, 4.0], device=dev)  # far start
    uv_cur[18] = torch.tensor([3.0, ym], device=dev)  # patch off the image
    uv_cur[19] = torch.tensor([nan, ym], device=dev)
    uv_cur[20:] += 0.75
    return im0, im1, uv_prev, uv_cur


def klt_l0_check(dev, fx) -> dict:
    """The kernel on 256 corners of frame 0 tracked into frame 1 (8
    iterations, from the template position) and back (4 iterations, from
    the forward result to the start), as the fused path calls it."""
    import velo_tpu_torch as vt
    from velo_tpu_torch.kernels import klt_l0 as kl
    from velo_tpu_torch.kernels._timing import graph_ms, median_ms
    from velo_tpu_torch.vision import corners

    vc = vt.config.VisionConfig(height=IMG_H, width=IMG_W, klt_impl="pallas")
    im0 = torch.as_tensor(fx.images[0], device=dev)
    im1 = torch.as_tensor(fx.images[1], device=dev)
    uv0 = corners.detect(im0, vc).uv.contiguous()
    if uv0.shape != (vc.k_tracks, 2):
        raise AssertionError(f"corners: {tuple(uv0.shape)}")
    fwd, _ = kl.track_level0_reference(im0, im1, uv0, uv0, vc, vc.klt_iters)
    calls = {"forward": (im0, im1, uv0, uv0, vc.klt_iters),
             "backward": (im1, im0, fwd, uv0, vc.klt_iters_fb)}
    per_call, max_err = [], 0.0
    for name, (a, b, up, uc, iters) in calls.items():
        uv, ok = kl.track_level0(a, b, up, uc, vc, iters)
        ruv, rok = kl.track_level0_reference(a, b, up, uc, vc, iters)
        torch.cuda.synchronize()
        if not (torch.equal(ok, rok) and torch.equal(uv, ruv)):
            raise AssertionError(
                f"klt_l0 {name}: kernel != plain: ok equal on "
                f"{(ok == rok).float().mean().item():.4f}, max |uv diff| "
                f"{(uv - ruv).abs().max().item()}")
        max_err = max(max_err, (uv - ruv).abs().max().item())
        n_ok = int(ok.sum())
        if n_ok < 100:
            raise AssertionError(f"klt_l0 {name}: only {n_ok} tracks ok")
        ms = median_ms(lambda: kl.track_level0(a, b, up, uc, vc, iters))
        # The kernel alone: launches replayed from a CUDA graph.
        kernel_ms = graph_ms(lambda: kl._launch(a, b, up, uc, iters))
        plain_ms = median_ms(
            lambda: kl.track_level0_reference(a, b, up, uc, vc, iters),
            bursts=7, calls=3)
        n_tmpl, n_steps, n_px = kl.work(a, b, up, uc, vc, iters)
        k = up.shape[0]
        # Bytes: the distinct float32 pixels this run's tracks read, both
        # positions in, uv and ok out.
        bound_ms, bound_by = _bound_ms(
            n_px * 4 + 2 * k * 8 + k * 9,
            n_tmpl * KLT_TEMPLATE_OPS + n_steps * KLT_STEP_OPS)
        per_call.append({"call": name, "h": IMG_H, "w": IMG_W, "k": k,
                         "iters": iters, "ms": ms, "kernel_only_ms": kernel_ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "templates": n_tmpl,
                         "steps": n_steps, "pixels_read": n_px, "ok": n_ok})
        print(f"klt_l0 {name} {IMG_H}x{IMG_W} K={k} iters={iters}: wrapper "
              f"{ms:.4f} ms (kernel alone {kernel_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}; "
              f"{n_tmpl} templates, {n_steps} steps, {n_px} pixels read), "
              f"{n_ok} ok, bitwise "
              "equal", flush=True)

    a, b, up, uc = _klt_edge_tracks(fx, dev, uv0)
    for iters in (vc.klt_iters, vc.klt_iters_fb, 0):
        uv, ok = kl.track_level0(a, b, up, uc, vc, iters)
        ruv, rok = kl.track_level0_reference(a, b, up, uc, vc, iters)
        torch.cuda.synchronize()
        if not (torch.equal(ok, rok) and torch.equal(uv, ruv)):
            raise AssertionError(f"klt_l0 edge tracks, iters {iters}: kernel "
                                 f"!= plain: ok {ok.tolist()} vs "
                                 f"{rok.tolist()}")
        if bool(ok[[0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 13, 15, 16]].any()):
            raise AssertionError("klt_l0 edge tracks: a NaN, outside, "
                                 f"border or textureless track is ok: {ok}")
        print(f"klt_l0 edge tracks iters={iters}: {int(ok.sum())} of "
              f"{len(ok)} ok, bitwise equal", flush=True)
    return {"per_shape": per_call, "max_abs_err": max_err}


def _pose_errors(a: np.ndarray, b: np.ndarray):
    """Per-frame translation (m) and rotation (deg) difference of poses."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dt = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1)
    R = np.einsum("fji,fjk->fik", a[:, :3, :3], b[:, :3, :3])
    # atan2 of sin and cos: arccos of the trace alone rounds small angles
    # of not-quite-orthonormal float32 rotations to 0.
    sin = np.linalg.norm(np.stack([R[:, 2, 1] - R[:, 1, 2],
                                   R[:, 0, 2] - R[:, 2, 0],
                                   R[:, 1, 0] - R[:, 0, 1]], 1), axis=1) / 2
    cos = (np.trace(R, axis1=1, axis2=2) - 1.0) / 2.0
    return dt, np.degrees(np.arctan2(sin, cos))


def _carry_leaves(carry):
    leaves = [x for x in carry if isinstance(x, torch.Tensor)]
    leaves += list(carry.edge_map) + list(carry.planar_map)
    if carry.vision is not None:
        v = carry.vision
        leaves += list(v.pyr) + [g for pair in v.grads for g in pair]
        leaves += list(v.tracks)
    return leaves


def _profile(frames, cfg, carry, cam) -> dict:
    """torch.profiler over 2 frames from a warm carry: wall time, summed
    card kernel time, kernel count, and the two port kernels' shares."""
    from torch.profiler import ProfilerActivity, profile

    from velo_tpu_torch.pipeline import odometry

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        odometry.run_sequence(frames, cfg, carry=carry, cam=cam)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, n, own = 0.0, 0, {"klt_l0": 0.0, "dist_topk": 0.0}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dt = getattr(ev, "device_time", None)
            dt = getattr(ev, "cuda_time", 0.0) if dt is None else dt
            busy += dt * 1e-6
            n += 1
            for key in own:
                if key in ev.name:
                    own[key] += dt * 1e-6
    return {"frames": len(frames), "wall_s": wall, "device_s": busy,
            "kernels": n, "busy_share": busy / wall,
            "klt_l0_s": own["klt_l0"], "dist_topk_s": own["dist_topk"]}


def pipeline_run(dev, mode, fx, grids) -> dict:
    """One cell: "fused" (level 0 through ``klt_l0``), "fused-gather" (the
    shipped ``klt_impl="auto"``, level 0 on the gather sampler; no CPU
    run) or "lidar"."""
    import velo_tpu_torch as vt
    from velo_tpu_torch.geom import camera
    from velo_tpu_torch.kernels.dist_topk import dist_topk
    from velo_tpu_torch.kernels.klt_l0 import track_level0
    from velo_tpu_torch.pipeline import odometry

    fused = mode != "lidar"
    cfg = vt.config.VeloConfig(
        lidar=vt.config.LidarConfig(n_rings=RINGS, n_azimuth=AZ),
        vision=vt.config.VisionConfig(
            height=IMG_H, width=IMG_W,
            klt_impl="auto" if mode == "fused-gather" else "pallas"),
        use_vision=fused, use_map=True, prebin_host=True)
    frames = ([g + (img,) for g, img in zip(grids, fx.images)] if fused
              else grids)
    cam = (camera.from_numpy(fx.P, fx.T_cam_velo, IMG_W, IMG_H, dev)
           if fused else None)

    dist_topk.launches = 0
    track_level0.launches = 0
    poses, diags, carry = odometry.run_sequence(frames, cfg, device=dev,
                                                cam=cam)
    torch.cuda.synchronize()
    launches = {"dist_topk": dist_topk.launches,
                "klt_l0": track_level0.launches}
    expect = {"dist_topk": 4 * N_FRAMES,
              "klt_l0": 2 * N_FRAMES if mode == "fused" else 0}
    if launches != expect:
        raise AssertionError(f"{mode}: launches {launches}, expected "
                             f"{expect}")
    if not all(x.is_cuda for x in _carry_leaves(carry)):
        raise AssertionError(f"{mode}: carry left the card")
    if not np.all(np.isfinite(poses)) or poses.shape != (N_FRAMES, 4, 4):
        raise AssertionError(f"{mode}: bad poses: shape {poses.shape}")

    gt = np.linalg.inv(fx.gt_poses_velo[0]) @ fx.gt_poses_velo
    gt_t, gt_r = _pose_errors(poses, gt)
    print(f"{mode}: pose error vs ground truth: max {gt_t.max():.4f} m, "
          f"{gt_r.max():.4f} deg; n_depth {diags['n_depth'].tolist()}",
          flush=True)
    if gt_t.max() > GATE_GT_M or gt_r.max() > GATE_GT_DEG[mode]:
        raise AssertionError(f"{mode}: pose error vs ground truth above the "
                             "gate")

    cpu = _cpu_compare(mode, frames, cfg, cam, poses, diags) \
        if mode != "fused-gather" else {}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, warm = odometry.run_sequence(frames, cfg, device=dev, cam=cam)
    torch.cuda.synchronize()
    fps = N_FRAMES / (time.perf_counter() - t0)
    prof = _profile(frames[:2], cfg, warm, cam) if fused else None
    if prof is not None:
        print(f"{mode}: profile of 2 warm frames: {prof}", flush=True)
    return {"mode": mode, "launches": launches, "fps": fps,
            "gt_err_m": float(gt_t.max()), "gt_err_deg": float(gt_r.max()),
            **cpu, "n_depth": diags["n_depth"].tolist(), "profile": prof}


def _cpu_compare(mode, frames, cfg, cam, poses, diags) -> dict:
    """The same frames through the port's CPU path (plain kernels)."""
    from velo_tpu_torch.pipeline import odometry

    t0 = time.perf_counter()
    cpu_poses, cpu_diags, _ = odometry.run_sequence(frames, cfg,
                                                    device="cpu", cam=cam)
    cpu_t, cpu_r = _pose_errors(poses, cpu_poses)
    bitwise = bool(np.array_equal(poses, cpu_poses))
    for f in range(N_FRAMES):
        print(f"{mode} frame {f}: card vs CPU {cpu_t[f]:.6f} m, "
              f"{cpu_r[f]:.6f} deg", flush=True)
    print(f"{mode}: card vs CPU over {N_FRAMES} frames: max "
          f"{cpu_t.max():.6f} m, {cpu_r.max():.6f} deg, poses bitwise equal: "
          f"{bitwise}, n_depth equal: "
          f"{bool(np.array_equal(diags['n_depth'], cpu_diags['n_depth']))} "
          f"(CPU run {time.perf_counter() - t0:.1f} s)", flush=True)
    if cpu_t.max() > GATE_CPU_M or cpu_r.max() > GATE_CPU_DEG:
        raise AssertionError(f"{mode}: card and CPU poses disagree")
    return {"cpu_diff_m": float(cpu_t.max()),
            "cpu_diff_deg": float(cpu_r.max()), "cpu_bitwise": bitwise}


def _cli(argv, device=None):
    """``velo_tpu_torch.cli.main(argv + ["--json"])`` in process, on the
    card unless ``device`` says otherwise -> (the --json line's result,
    what it wrote to stderr, the kernels' launch counts of this call)."""
    from velo_tpu_torch import cli
    from velo_tpu_torch.kernels.dist_topk import dist_topk
    from velo_tpu_torch.kernels.klt_l0 import track_level0

    out, err = io.StringIO(), io.StringIO()
    dist_topk.launches = 0
    track_level0.launches = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv + ["--json"]
                      + (["--device", device] if device else []))
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"cli.main({argv}) returned {rc}")
    launches = {"dist_topk": dist_topk.launches,
                "klt_l0": track_level0.launches}
    if device == "cpu" and any(launches.values()):
        raise AssertionError(f"a CPU run launched kernels: {launches}")
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue(), launches


def _expect_launches(what, launches, dist_topk, klt_l0):
    expect = {"dist_topk": dist_topk, "klt_l0": klt_l0}
    if launches != expect:
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{expect}")


def _relative_error(est, gt):
    """Per-frame relative motion against ground truth (m), as the
    reference's own test of the KITTI path measures it."""
    rel_e = np.einsum("fij,fjk->fik", np.linalg.inv(est[:-1]), est[1:])
    rel_g = np.einsum("fij,fjk->fik", np.linalg.inv(gt[:-1]), gt[1:])
    return np.linalg.norm(rel_e[:, :3, 3] - rel_g[:, :3, 3], axis=1)


def _compare_to_cpu(what, card, cpu) -> dict:
    """Card against the port's CPU run of the same arguments."""
    dt, dr = _pose_errors(card, cpu)
    bitwise = bool(np.array_equal(card, cpu))
    print(f"{what}: card vs CPU over {len(card)} frames: max {dt.max():.6f} "
          f"m, {dr.max():.6f} deg, bitwise equal: {bitwise}", flush=True)
    if dt.max() > GATE_CPU_M or dr.max() > GATE_CPU_DEG:
        raise AssertionError(f"{what}: card and CPU poses disagree")
    return {"cpu_diff_m": float(dt.max()), "cpu_diff_deg": float(dr.max()),
            "cpu_bitwise": bitwise}


def _smoother_seconds(stderr: str) -> float:
    """The command line's own smoother time (it prints 0.1 s steps)."""
    return float(re.search(r"smoother: .*\((\d+\.\d)s\)", stderr).group(1))


def export_phase(tmp) -> str:
    from velo_tpu_torch.io import fake_kitti, fixtures, kitti, png
    from velo_tpu_torch.lidar.rangeimage import hdl64e_beam_elevations

    root = os.path.join(tmp, "kitti")
    t0 = time.perf_counter()
    seq_dir = fake_kitti.export(root, seq="00", frames=N_FRAMES, rings=RINGS,
                                azimuth=AZ, height=IMG_H, width=IMG_W,
                                seed=SEED)
    # The drive the exporter simulated (memoized: the same arguments).
    fx = fixtures.make_fixture(
        n_frames=N_FRAMES, n_rings=RINGS, n_azimuth=AZ, height=IMG_H,
        width=IMG_W, with_images=True, seed=SEED,
        beam_elev=hdl64e_beam_elevations(RINGS), az_start=float(np.pi))
    n_bytes = 0
    for i in range(N_FRAMES):
        path = os.path.join(seq_dir, "image_0", f"{i:06d}.png")
        n_bytes += os.path.getsize(path)
        img8 = np.clip(fx.images[i] * 255.0, 0, 255).astype(np.uint8)
        if not np.array_equal(png.read_gray8(path), img8):
            raise AssertionError(f"export: {path} does not read back equal")
        scan = kitti.read_velodyne_bin(
            os.path.join(seq_dir, "velodyne", f"{i:06d}.bin"))
        if not np.array_equal(scan, fx.scans[i].astype(np.float32)):
            raise AssertionError(f"export: scan {i} does not read back equal")
    seq = kitti.KittiSequence(root, "00")
    if seq.n_frames != N_FRAMES or seq.gt_poses.shape != (N_FRAMES, 4, 4):
        raise AssertionError("export: the sequence does not open")
    print(f"export: {N_FRAMES} frames ({RINGS} x {AZ} hdl64e scans, {IMG_H} x "
          f"{IMG_W} PNGs, {n_bytes} bytes of them) written and read back "
          f"equal in {time.perf_counter() - t0:.1f} s", flush=True)
    return root


def cli_kitti(dev, tmp, root, smi) -> dict:
    """This slice's path at full width: the command line from a KITTI-layout
    directory to a KITTI pose file, fused through both kernels, with
    checkpoint, resume and the smoother."""
    from velo_tpu_torch.config import (LidarConfig, VeloConfig,
                                       apply_overrides)
    from velo_tpu_torch.io import kitti
    from velo_tpu_torch.kernels.dist_topk import dist_topk
    from velo_tpu_torch.kernels.klt_l0 import track_level0
    from velo_tpu_torch.lidar import rangeimage as ri_mod
    from velo_tpu_torch.pipeline import checkpoint, odometry, smoother

    def path(*parts):
        return os.path.join(tmp, *parts)

    base = ["--kitti-root", root, "--seq", "00", "--set", KITTI_SET]
    every = ["--checkpoint-every", str(N_FRAMES // 2)]
    gt = kitti.read_poses(os.path.join(root, "poses", "00.txt"))

    # The uninterrupted run: forward, then the smoother.
    res, err, launches = _cli(
        base + ["--frames", str(N_FRAMES), "--out", path("smooth"),
                "--checkpoint", path("ck.npz"), "--smooth"] + every)
    _expect_launches("cli-kitti", launches,
                     4 * N_FRAMES + 2 * N_FRAMES * SMOOTH_PASSES,
                     2 * N_FRAMES)
    smoothed = kitti.read_poses(path("smooth", "00.txt"))
    if smoothed.shape != (N_FRAMES, 4, 4) or not np.isfinite(smoothed).all():
        raise AssertionError(f"cli-kitti: bad pose file {smoothed.shape}")
    if res["frames"] != N_FRAMES or "ate_rmse_m" not in res:
        raise AssertionError(f"cli-kitti: result line {res}")
    cli_smooth_s = _smoother_seconds(err)
    full = checkpoint.load_history(path("ck.npz"))
    if checkpoint.checkpoint_frame(path("ck.npz")) != N_FRAMES:
        raise AssertionError("cli-kitti: the last checkpoint is not the end")

    # A run that ends after half the frames, then --resume over all.
    half = N_FRAMES // 2
    _, _, n_half = _cli(base + ["--frames", str(half), "--out", path("half"),
                                "--checkpoint", path("ck2.npz")] + every)
    _expect_launches("cli-kitti, first half", n_half, 4 * half, 2 * half)
    if checkpoint.checkpoint_frame(path("ck2.npz")) != half:
        raise AssertionError("cli-kitti: no checkpoint at the interruption")
    res_r, _, n_res = _cli(
        base + ["--frames", str(N_FRAMES), "--out", path("resumed"),
                "--checkpoint", path("ck2.npz"), "--resume"] + every)
    _expect_launches("cli-kitti, resumed", n_res, 4 * (N_FRAMES - half),
                     2 * (N_FRAMES - half))
    resumed = checkpoint.load_history(path("ck2.npz"))
    if sorted(resumed) != sorted(full) or not all(
            np.array_equal(resumed[k], full[k]) for k in full):
        raise AssertionError("cli-kitti: the resumed run's trajectory or "
                             "diagnostics differ from the uninterrupted "
                             "run's")
    seq = kitti.KittiSequence(root, "00")
    kitti.write_poses(path("forward.txt"), odometry.velo_to_cam_trajectory(
        full["poses"], seq.calib["Tr"]))
    with open(path("forward.txt"), "rb") as a, \
            open(path("resumed", "00.txt"), "rb") as b:
        if a.read() != b.read():
            raise AssertionError("cli-kitti: the resumed pose file is not "
                                 "the uninterrupted forward trajectory")
    forward = kitti.read_poses(path("resumed", "00.txt"))
    print(f"cli-kitti: resumed from frame {half}: trajectory, diagnostics "
          "and pose file bitwise equal to the uninterrupted forward run",
          flush=True)

    rel_f, rel_s = _relative_error(forward, gt), _relative_error(smoothed, gt)
    print(f"cli-kitti: relative motion vs ground truth, median / max: "
          f"forward {np.median(rel_f):.4f} / {rel_f.max():.4f} m, smoothed "
          f"{np.median(rel_s):.4f} / {rel_s.max():.4f} m; n_depth "
          f"{full['n_depth'].tolist()}", flush=True)
    if np.median(rel_f) > GATE_REL_M or np.median(rel_s) > GATE_REL_M:
        raise AssertionError("cli-kitti: relative motion above the gate")

    # The smoother as a library, pass by pass from the forward trajectory
    # (each pass re-collects its features, so two calls of one pass are one
    # call of two): timed, frame 0 kept, equal to the command line's file.
    lcfg = apply_overrides(VeloConfig(lidar=LidarConfig(
        ring_mode="hdl64e", az_start=float(np.pi)), prebin_host=True),
        KITTI_SET)
    grids = [ri_mod.bin_scan_host(scan[mask], lcfg.lidar)
             for scan, mask in map(seq.scan, range(N_FRAMES))]
    scans = np.stack([g[0] for g in grids])
    masks = np.stack([g[1] for g in grids])
    poses, pass_s, per_pass = full["poses"], [], []
    dist_topk.launches = 0
    track_level0.launches = 0
    for _ in range(SMOOTH_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses = smoother.smooth_trajectory(
            scans, masks, poses, lcfg, window=SMOOTH_WINDOW, passes=1,
            device=dev)
        torch.cuda.synchronize()
        pass_s.append(time.perf_counter() - t0)
        per_pass.append(poses)
    _expect_launches("smoother", {"dist_topk": dist_topk.launches,
                                  "klt_l0": track_level0.launches},
                     2 * N_FRAMES * SMOOTH_PASSES, 0)
    # The gauge fix re-bases every pose on frame 0: float32 rounding apart,
    # it stays where the forward pass put it.
    if not np.allclose(poses[0], full["poses"][0], atol=1e-5):
        raise AssertionError("smoother: frame 0 moved")
    kitti.write_poses(path("library.txt"), odometry.velo_to_cam_trajectory(
        poses, seq.calib["Tr"]))
    with open(path("library.txt"), "rb") as a, \
            open(path("smooth", "00.txt"), "rb") as b:
        if a.read() != b.read():
            raise AssertionError("smoother: the library's passes and the "
                                 "command line's file differ")
    moved = _pose_errors(poses, full["poses"])
    print(f"smoother: {SMOOTH_PASSES} passes of {pass_s} s (the command line "
          f"said {cli_smooth_s} s for both), window {SMOOTH_WINDOW}; moved "
          f"the poses by up to {moved[0].max():.4f} m, {moved[1].max():.4f} "
          f"deg; frame 0 kept; equal to the command line's file", flush=True)

    # Card against CPU: the forward run and one smoother pass.
    t0 = time.perf_counter()
    _, err_c, _ = _cli(
        base + ["--frames", str(N_FRAMES), "--out", path("cpu"),
                "--checkpoint", path("ckc.npz"), "--smooth",
                "--smooth-passes", "1"] + every, device="cpu")
    print(f"cli-kitti: CPU run in {time.perf_counter() - t0:.1f} s, its "
          f"smoother pass {_smoother_seconds(err_c)} s", flush=True)
    cpu_fwd = checkpoint.load_history(path("ckc.npz"))["poses"]
    cmp_f = _compare_to_cpu("cli-kitti forward", full["poses"], cpu_fwd)
    # Like with like: the card's first pass through the same pose file.
    kitti.write_poses(path("pass1.txt"), odometry.velo_to_cam_trajectory(
        per_pass[0], seq.calib["Tr"]))
    cmp_s = _compare_to_cpu("cli-kitti one smoother pass",
                            kitti.read_poses(path("pass1.txt")),
                            kitti.read_poses(path("cpu", "00.txt")))
    print(f"cli-kitti 64x2048 fused, {N_FRAMES} frames incl. host I/O: "
          f"{res['fps']} frames/s; smoother {pass_s[0]:.3f} s per pass on "
          f"{smi}", flush=True)
    return {"launches": launches, "fps_incl_io": res["fps"],
            "fps_incl_io_resumed_half": res_r["fps"],
            "smoother_pass_s": pass_s, "cli_smoother_s": cli_smooth_s,
            "rel_err_forward_m": rel_f.tolist(),
            "rel_err_smoothed_m": rel_s.tolist(),
            "ate_rmse_m": res["ate_rmse_m"],
            "smoother_moved_m": float(moved[0].max()),
            "forward": cmp_f, "smoother_pass": cmp_s,
            "n_depth": full["n_depth"].tolist()}


def cli_variants(tmp) -> dict:
    """The off-default variants the command line selects, at full width and
    a smaller depth: plain, ``--fast`` (deferred-tail LM), ``--no-prebin``
    (deskew and range image from the raw scan, on the device)."""
    from velo_tpu_torch.io import fixtures, kitti

    n = N_VARIANT_FRAMES
    base = ["--synthetic", "--frames", str(n), "--rings", str(RINGS),
            "--azimuth", str(AZ), "--no-vision"]
    # What the command line simulates (memoized: the same arguments).
    fx = fixtures.make_fixture(n_frames=n, n_rings=RINGS, n_azimuth=AZ,
                               height=128, width=384, with_images=False,
                               seed=0)
    gt = np.linalg.inv(fx.gt_poses_cam[0]) @ fx.gt_poses_cam
    out, poses = {}, {}
    for name, flags in (("plain", []), ("fast", ["--fast"]),
                        ("no-prebin", ["--no-prebin"])):
        res, _, launches = _cli(base + flags + [
            "--out", os.path.join(tmp, "v-" + name)])
        _expect_launches(f"cli {name}", launches, 4 * n, 0)
        p = kitti.read_poses(os.path.join(tmp, "v-" + name, "synthetic.txt"))
        if p.shape != (n, 4, 4) or not np.isfinite(p).all():
            raise AssertionError(f"cli {name}: bad pose file {p.shape}")
        gt_t, gt_r = _pose_errors(p, gt)
        print(f"cli {name}: pose error vs ground truth: max {gt_t.max():.4f} "
              f"m, {gt_r.max():.4f} deg; {res['fps']} frames/s incl. host "
              "I/O", flush=True)
        if gt_t.max() > GATE_GT_M or gt_r.max() > GATE_GT_DEG["lidar"]:
            raise AssertionError(f"cli {name}: pose error vs ground truth "
                                 "above the gate")
        poses[name] = p
        out[name] = {"launches": launches, "fps_incl_io": res["fps"],
                     "gt_err_m": float(gt_t.max()),
                     "gt_err_deg": float(gt_r.max())}
        if name != "plain":  # the LiDAR cell above is the plain run's
            _cli(base + flags + ["--out", os.path.join(tmp, "c-" + name)],
                 device="cpu")
            out[name].update(_compare_to_cpu(
                f"cli {name}", p, kitti.read_poses(
                    os.path.join(tmp, "c-" + name, "synthetic.txt"))))
    # The raw-scan front end against host pre-binning: the host's float64
    # and the device's float32 elevation put a few cells into neighbouring
    # rings, so not bitwise, but within the card-vs-CPU gate.
    dt, dr = _pose_errors(poses["no-prebin"], poses["plain"])
    print(f"cli no-prebin vs pre-binned: max {dt.max():.6f} m, "
          f"{dr.max():.6f} deg; --fast vs plain bitwise equal: "
          f"{bool(np.array_equal(poses['fast'], poses['plain']))}",
          flush=True)
    if dt.max() > GATE_CPU_M or dr.max() > GATE_CPU_DEG:
        raise AssertionError("cli: --no-prebin and the pre-binned run "
                             "disagree")
    out["no-prebin"].update(prebin_diff_m=float(dt.max()),
                            prebin_diff_deg=float(dr.max()))
    return out


def main() -> int:
    t_start = time.perf_counter()
    smi = card_check()
    dev = torch.device("cuda", 0)
    build()
    memoize_fixtures()
    fx, grids = make_frames()
    dk = dist_topk_check(dev)
    kk = klt_l0_check(dev, fx)
    runs = {mode: pipeline_run(dev, mode, fx, grids)
            for mode in ("fused", "fused-gather", "lidar")}
    for mode, run in runs.items():
        print(f"{mode} 64x2048 warm pass: {run['fps']:.3f} frames/s on "
              f"{smi}", flush=True)
    del fx, grids
    with tempfile.TemporaryDirectory() as tmp:
        root = export_phase(tmp)
        runs["cli-kitti"] = cli_kitti(dev, tmp, root, smi)
        runs["cli-variants"] = cli_variants(tmp)

    def entry(name, source, replaces, check, library_ms, **extra):
        # One frame's calls of the forward path; the smoother's shapes
        # stand in "per_shape" only.
        shapes = [s for s in check["per_shape"]
                  if s.get("path", "forward") == "forward"]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # This slice's path: the command line's KITTI run.
            "launches": runs["cli-kitti"]["launches"][name],
            "launches_by_path": {
                "fused": runs["fused"]["launches"][name],
                "lidar": runs["lidar"]["launches"][name],
                "cli-kitti": runs["cli-kitti"]["launches"][name],
                "cli-variants": sum(v["launches"][name] for v in
                                    runs["cli-variants"].values())},
            "max_abs_err": check["max_abs_err"],
            # Sums of the per-call medians.
            "ms": sum(s["ms"] for s in shapes),
            "plain_ms": sum(s["plain_ms"] for s in shapes),
            "bound_ms": sum(s["bound_ms"] for s in shapes),
            "bound_by": shapes[-1]["bound_by"],
            "library_ms": library_ms, "per_shape": check["per_shape"],
            **extra}

    kernels = [
        entry("dist_topk", "velo_tpu_torch/csrc/dist_topk.cu",
              "velo_tpu/pallas/dist_topk.py:49", dk,
              sum(s["library_ms"] for s in dk["per_shape"]
                  if s["path"] == "forward"),
              library_call="torch.topk(torch.cdist(q, t), 16, "
                           "largest=False): exact, unbinned"),
        entry("klt_l0", "velo_tpu_torch/csrc/klt_l0.cu",
              "velo_tpu/pallas/klt_l0.py:87", kk, None,
              library_call="none: no single PyTorch call computes "
                           "inverse-compositional Lucas-Kanade"),
    ]
    print(json.dumps({"pipeline": runs,
                      "seconds": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
