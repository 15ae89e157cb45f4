"""GPU smoke test of the PyTorch port: build, check and run it on one card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. card check: a CUDA device must be present; prints its name and power
   limit as nvidia-smi reports them;
2. build: compiles ``velo_tpu_torch/csrc/dist_topk.cu``, ``klt_l0.cu``,
   ``lm_lidar.cu``, ``lm_joint.cu`` and ``corr_fit.cu`` with nvcc
   (sm_90a), one process each, started together, then the native loader
   and PNG unfilter with g++;
3. fixture: one full-scale drive (64 x 2048 LiDAR, 192 x 640 images,
   4 frames, seed 0), host-pre-binned once and shared by the phases below;
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
   ``lm_lidar`` on every LM solve of 3 eager LiDAR frames (1024 edges,
   2048 planars), against the plain solve, with the wrapper's, the
   kernel's and the plain solve's ms per solve, one wrapper call and one
   card kernel per call (profiled replays of a captured call) and the
   bound from one read of its inputs and its float64 operations;
   ``lm_joint`` the same on every joint (LiDAR-visual) solve of 3 eager
   fused frames (6 a frame: the scan-to-scan solves), timed on the one
   with the most depth tracks; ``corr_fit`` on every correspondence fit of
   3 eager LiDAR frames, dense and hash engine (9 a frame), bitwise against
   its plain version, with the wrapper's, the kernel's (20 calls replayed
   from a CUDA graph) and the plain version's ms per call of a
   scan-to-scan and a map fit, one wrapper call and one card kernel per
   call, and the bound from one read of its inputs and one write of its
   outputs.  Every phase below also expects 9 ``corr_fit`` launches a frame
   (one per ICP outer iteration; 8 under ``ct_sweep``, whose redeskew
   solve is gone), and the smoother's 3 a frame and pass;
5. fused pipeline: the 4 frames through ``pipeline.odometry.run_sequence``
   at the bench's fused configuration with ``klt_impl="pallas"``; on the
   card each frame is one replay of a CUDA graph of the step, one graph per
   cadence key, captured afresh for each cell (a wrapper counts its calls:
   each graph's eager warm-up and its capture, ``_graph_calls``); a
   profile of 2 replayed frames must see ``klt_l0`` 2, ``dist_topk`` 4,
   ``lm_lidar`` 3 (the map solves) and ``lm_joint`` 6 times per frame
   (the scan-to-scan solves, which carry the visual blocks); the carry
   stays on the card, the poses
   within the
   gates against ground truth, equal to the port's own CPU run of the same
   frames, and the profile reads the card's busy share;
6. the same fused run with the shipped ``klt_impl="auto"`` (level 0 on the
   gather sampler, no ``klt_l0`` launch): ground truth, frames/s and
   profile beside the kernel's, to decide which should be the default;
7. LiDAR-only pipeline: the same frames without images, the checks of the
   first slice (4 ``dist_topk`` and 9 ``lm_lidar`` launches per frame,
   ground truth, CPU);
7a. the solver variants that ``--set`` selects, each a cell on the same
   frames: ``ct-fused`` (``ct_sweep``, fused with ``klt_impl="pallas"``;
   4 ``dist_topk``, 2 ``klt_l0``, 3 ``lm_lidar`` and no ``lm_joint``
   launches per frame: its scan-to-scan solve is 12-DoF and plain),
   ``exact-lag`` (``deskew_exact_lag``, LiDAR-only; 4 / 0 / 9 / 0),
   ``hash`` (``nn_engine="hash"``, LiDAR-only; 0 / 0 / 9 / 0),
   ``klt-matmul`` and ``klt-window`` (fused, the selection-matmul and
   local-window KLT; 4 / 0 / 3 / 6) and ``nn-xla`` (LiDAR-only, the exact
   search of ``nn_approx_impl="xla"``; 0 / 0 / 9 / 0):
   ground truth (ct_sweep against the reference's own error,
   ``GATE_GT_M_CT``), card against CPU on frames 0-1, warm frames/s;
7b. run-scan, this slice's path: ``odometry.run_scan`` fused and
   LiDAR-only on the same frames, bitwise against the eager ``step`` loop
   on the card and against the CPU runs of 5 and 7; launches per replayed
   frame of each of the port's kernels from a profile; graphs captured and
   their seconds; warm frames/s,
   host ms per frame and the card's busy share, captured beside eager;
8. export: ``io.fake_kitti.export`` writes 4 full-scale frames (HDL-64E
   beam table, sweep start at the rear) as a KITTI sequence directory; the
   scans and PNGs read back equal to what was written;
9. cli-kitti: ``velo_tpu_torch.cli.main`` in process on that directory
   (scans through the native binned loader, which its stderr must name),
   fused with ``klt_impl=pallas``, with a checkpoint every 2 frames and the
   smoother (window 8, 2 passes): launch counts (forward 4 ``dist_topk``,
   2 ``klt_l0``, 3 ``lm_lidar`` and 6 ``lm_joint`` per frame, smoother 2
   ``dist_topk`` per frame and pass, at the window-map shapes, and no LM
   kernel: its solves carry no motion prior), relative motion within 10 cm
   of ground truth
   in the median before and after smoothing, an interrupted run resumed to
   the bitwise forward trajectory, the smoother called as a library pass by
   pass (timed; frame 0 kept; equal to the command line's file), and the
   forward run and one smoother pass against ``--device cpu``;
10. cli-variants: ``--synthetic --rings 64 --azimuth 2048 --no-vision`` over
    4 frames, plain, ``--fast`` and ``--no-prebin``: ground truth, card
    against CPU, raw-scan against pre-binned;
10a. png: a 1241 x 376 PNG with mixed scanline filters, the native
    unfilter byte for byte against the Python loop, ms per frame of both
    and how long a second Python thread waits during each (GIL);
10b. loader: ``NativeBinnedScanLoader`` over the exported directory
    against ``bin_scan_host`` (masks equal, grids within 1e-6), ms per
    frame;
11. batch (config 5): ``--synthetic --batch 4 --frames 4
    --rings 64 --azimuth 2048`` in process, fused with ``--set
    v:klt_impl=pallas`` and ``--no-vision`` (seeds 100-103, the batch
    mode's 128 x 384 images; the drives are simulated in worker processes
    while the phases above run): wrapper calls per frame and graph as
    the single step's whatever B, each sequence within the ground-truth
    gates, the library's ``run_sequences`` (``batched_run_scan``) on the
    same inputs byte-equal to the pose files and, sequence by sequence,
    bitwise equal to single-sequence ``run_sequence`` runs on the card
    (else it fails, naming the first differing frame and field), sequence
    0 to the CPU; ``--shard`` on the one card byte-equal to the unsharded
    run;
11a. batch variants: each solver variant through ``--batch 2`` with
    functorch's per-sample fallback off: launches per frame as single,
    ground truth, each sequence against its single-sequence card run;
11b. distributed: ``pipeline.distributed.run_sequences_multihost`` in two
    processes joined by gloo over loopback, both on this card, 2 LiDAR
    sequences x 3 frames each (the batch phase's drives): each rank's poses
    byte-equal to a single-process ``batch.run_sequences`` of its
    sequences, the global cost the mean over all 4;
11c. long drive: 40 frames of seed 0 at 64 x 2048, LiDAR-only, host
    pre-binned, shipped solver and map (``velo_tpu_torch.evaluation.
    longrun``: its fixture, simulated in a worker process from the start,
    its cold ``run_scan`` and its drift row): 4 ``dist_topk`` and 9
    ``lm_lidar`` wrapper calls per frame and graph; both map rings must
    wrap (each ring's write head against the points inserted, frame by
    frame); the same drive warm as
    two ``run_scan`` calls split at an odd frame, bitwise equal to the
    cold call; one CPU step from the card's carry at two frames after the
    wrap against the card's pose and every carry leaf (bitwise, else 5 cm
    / 0.1 deg); launches per replayed frame after the wrap (profiler);
    median relative error <= 0.04 m and ATE <= 1.0 m; warm frames/s;
11d. fixtures-accel: the drive simulator on the card (``VELO_FIX_ACCEL=1``,
    ``velo_tpu_torch.io.fixtures_accel``): (a) the long drive of 11c
    through ``longrun.get_fixture`` into a cache of its own (file tagged
    ``_accel-torch-cuda``), frame by frame against 11c's numpy drive
    within the reference's bounds (lengths within max(2, 0.1 %), 99th
    percentile of point distance < 1 mm), its seconds split into host
    set-up, device raycast, host tail and pad + cache write, beside one
    numpy frame timed on the host; (b) the fused fixture of phase 3 with
    images, against its numpy images (99.9th percentile of |diff| < 1e-2,
    mean < 1e-4); (c) the card against the port's CPU on frames 0-1 of
    both (hit distances and scans bitwise or not, images' max |diff| and
    pixels that differ; hit distances within 1 mm, misses equal); (d)
    11c's cold ``run_scan`` on the accelerated drive: 4 ``dist_topk`` and
    9 ``lm_lidar`` wrapper calls per frame and graph, median relative
    error <= 0.04 m and ATE <= 1.0 m;
12. batched kernels: both under ``torch.func.vmap`` at B = 4 and 8 (inputs
    batched, and shared at batch stride 0): one launch per call, each
    sequence bitwise equal to its unbatched launch and to the plain
    version, with wrapper, kernel-alone, plain, library and bound times;
13. batch throughput: ``run_sequences`` (``batched_run_scan``, one graph
    replay per batched frame) at B = 1, 2, 4, 8, warm (aggregate frames/s);
    at B = 1 and 8 the host's time per step call and a profile of one step
    (busy share, card kernels), eager and captured; the plain step's host
    time.

Each phase prints its seconds, and the pipeline line carries them.

Prints a JSON line of pipeline results, one of per-kernel results, then as
its last line ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from benchmarks import roofline
from benchmarks.roofline import dist_topk as dist_topk_roof
from benchmarks.roofline import klt_l0 as klt_l0_roof
from benchmarks.roofline import lm_lidar as lm_lidar_roof
from velo_tpu_torch.kernels._build import KERNELS

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
# Frames of the fixture cells, the KITTI export and the command line on it:
# 8 until the batch phase came, cut to 4 to keep the script inside its
# time limit (the smoother's window maps keep their 2 * 8 + 1 frames of
# padded shape).
N_FRAMES = 4
# The smoother's corr_fit calls over N_FRAMES: a scan-to-map solve of
# icp_iters_map (3) outer iterations per frame and pass, each one fit.
SMOOTH_CORR = 3 * N_FRAMES * SMOOTH_PASSES
N_VARIANT_FRAMES = 4
GATE_REL_M = 0.10  # median relative per-frame motion vs ground truth (m)
KITTI_SET = "v:klt_impl=pallas"  # --set of the command line's KITTI run
SEED = 0
RINGS, AZ, IMG_H, IMG_W = 64, 2048, 192, 640
GATE_GT_M = 0.25  # full-scale pose error vs ground truth (m)
# The continuous-time sweep solve misses 0.25 m on these drives in the
# reference itself: JAX on the CPU ends 0.4479 m (fused, seed 0), 0.4105 m
# (LiDAR, seed 0), 0.4319 and 0.4535 m (the --batch drives, seeds 100 and
# 101) from ground truth at frame 3; the port 0.4587, 0.4352, 0.4228 and
# 0.4354 m (tests/reference_gt_error.py).  Its gate is the reference's
# error plus about the end-to-end parity tolerance of 5 cm.
GATE_GT_M_CT = 0.50
GATE_GT_DEG = {"lidar": 1.0, "fused": 1.5, "fused-gather": 1.5,
               "ct-fused": 1.5, "exact-lag": 1.0, "hash": 1.0,
               "klt-matmul": 1.5, "klt-window": 1.5, "nn-xla": 1.0}  # (deg)
# The solver variants that --set selects, each a cell of its own at the
# fixture's full width: (fused, --set, dist_topk and klt_l0 launches per
# frame, (lm_lidar, lm_joint, corr_fit) launches per frame).  The hash
# engine bypasses dist_topk in both solves.  lm_lidar runs each LM solve of
# the LiDAR-only system: 3 scan-to-map and 5 + 1 scan-to-scan a LiDAR
# frame; a fused frame's 5 + 1 scan-to-scan solves carry the visual blocks
# and run on lm_joint; ct_sweep's are 12-DoF and stay plain, and --fast's
# deferred-tail LM bypasses both.  corr_fit runs each outer iteration's
# fit: 9 a frame, 8 with ct_sweep (5 + 3: no redeskew solve).
LM_LIDAR, LM_FUSED, LM_CT_FUSED = (9, 0, 9), (3, 6, 9), (3, 0, 8)
LM_FAST, LM_NONE = (0, 0, 9), (0, 0, 0)
VARIANTS = {"ct-fused": (True, "s:ct_sweep=1", 4, 2, LM_CT_FUSED),
            "exact-lag": (False, "s:deskew_exact_lag=1", 4, 0, LM_LIDAR),
            "hash": (False, "s:nn_engine=hash", 0, 0, LM_LIDAR),
            # The reference's other samplers and its XLA top-k:
            # selection-matmul and local-window KLT (no klt_l0: the whole
            # pyramid samples by products), and the exact search in place
            # of dist_topk.
            "klt-matmul": (True, "v:klt_impl=matmul", 4, 0, LM_FUSED),
            "klt-window": (True, "v:klt_impl=window", 4, 0, LM_FUSED),
            "nn-xla": (False, "s:nn_approx_impl=xla", 0, 0, LM_LIDAR)}
VARIANT_CPU_FRAMES = 2  # card against CPU on frames 0-1
GATE_CPU_M, GATE_CPU_DEG = 0.05, 0.1  # card vs the port's own CPU run
# The kernels' bounds are benchmarks/roofline's: the H100's peaks and each
# kernel's work per call.  lm_joint's is lm_lidar's plus the tracks
# (all of the table, masked or not, as the kernel reads them): per track
# xyz, obs, its weight, two masks and the float64 x1, x2, and once the
# camera (P, T_cam_velo and its inverse, w_scale).
# Float64 operations per track and pass, counted from the source: the
# reprojection's full pass two residual rows of 43 products and sums plus
# two transforms, the projection and the 3 x 6 and 2 x 6 chains (~383),
# its cost-only pass ~65; the epipolar full pass its line, norm and dot
# twice and six generator derivatives of ~30 plus the 43 sums (~316), its
# cost-only pass ~27.
LM_TRACK_BYTES = 12 + 8 + 4 + 1 + 1 + 24 + 24
LM_CAMERA_BYTES = 48 + 64 + 64 + 4
LM_TRACK_F64_OPS = 383 + 65 + 316 + 27
LM_FRAMES = 3  # eager frames whose solves lm_lidar_check / lm_joint_check
# record (LiDAR / fused)
# What the instruction rate allows dist_topk, beside the bound: the bitwise
# contract forbids fusing a product with its sum, so a query-target pair is
# 3 products, 3 sums (the fourth product is by 1) and a minimum at half
# rate, 8 lane slots on 132 SMs x 128 float32 lanes at 1.98 GHz.
DIST_TOPK_SLOTS_PER_PAIR = 8
FP32_LANE_SLOTS_S = 132 * 128 * 1.98e9

# The batch mode (config 5) at full width: the command line's --batch with
# its 128 x 384 images, 4 sequences (seeds 100-103) x 4 frames (the
# reference's default is 20 frames; the depth is cut to keep the script
# inside its time limit).
BATCH, BATCH_FRAMES = 4, 4
BATCH_H, BATCH_W, BATCH_K = 128, 384, 128
BATCH_SIZES = (1, 2, 4, 8)  # throughput; 8 is the four sequences twice
BATCH_ARGV = ["--synthetic", "--batch", str(BATCH), "--frames",
              str(BATCH_FRAMES), "--rings", str(RINGS), "--azimuth", str(AZ)]
BATCH_MODES = {"fused": ["--set", "v:klt_impl=pallas"],
               "lidar": ["--no-vision"]}
# The solver variants through --batch 2 (seeds 100-101 of the drives
# above).
BATCH_VARIANTS = {"ct-fused": ["--set", "v:klt_impl=pallas,s:ct_sweep=1"],
                  "exact-lag": ["--no-vision", "--set",
                                "s:deskew_exact_lag=1"],
                  "hash": ["--no-vision", "--set", "s:nn_engine=hash"]}


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
    _build.build_all(KERNELS)
    for name in KERNELS:
        _build.load(name)
        regs = [ln.strip() for ln in _build.build_logs.get(name, "").split(
            "\n") if "registers" in ln or "spill" in ln]
        print(f"build: {name} nvcc "
              f"{_build.build_seconds.get(name, 0.0):.2f} s; {regs}",
              flush=True)
    print(f"build: the kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)
    from velo_tpu_torch.io import native_loader

    t0 = time.perf_counter()
    native_loader.load_library()
    print(f"build: the native loader and PNG unfilter (g++) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def _fixture_key(kw) -> tuple:
    return tuple(sorted((k, v.tobytes() if isinstance(v, np.ndarray) else v)
                        for k, v in kw.items()))


def _simulate(kw):
    """One drive, in a worker process of :func:`prefetch_fixtures`."""
    from velo_tpu_torch.io import fixtures

    return fixtures.make_fixture(**kw)


_FIXTURES: dict = {}


def memoize_fixtures() -> None:
    """The drive simulator is a pure function of its arguments and takes
    10-40 s at full scale; the command line simulates anew on every call
    and the phases below ask for the same drives several times.  A drive
    asked for without images is the one with images, when that was made:
    the renderer draws no random numbers, so the scans are the same.  With
    ``VELO_FIX_ACCEL=1`` (the fixtures-accel phase) it simulates anew: the
    memo holds numpy drives."""
    from velo_tpu_torch.io import fixtures

    make = fixtures.make_fixture

    def make_fixture(**kw):
        if os.environ.get("VELO_FIX_ACCEL") == "1":
            return make(**kw)
        key = _fixture_key(kw)
        if key not in _FIXTURES and kw.get("with_images") is False:
            key = _fixture_key({**kw, "with_images": True})
        if key not in _FIXTURES:
            _FIXTURES[_fixture_key(kw)] = make(**kw)
            key = _fixture_key(kw)
        return _FIXTURES[key]

    fixtures.make_fixture = make_fixture


def start_prefetch(kws, long_kw):
    """Start simulating drives in worker processes (spawned, one per
    drive), while the phases before the one that needs them run: the
    fixtures ``kws`` and the long drive (``longrun.get_fixture(**long_kw)``,
    whose future is the job's last item); the caller shuts the pool
    down."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from velo_tpu_torch.evaluation import longrun

    pool = ProcessPoolExecutor(
        max_workers=len(kws) + 1,
        mp_context=multiprocessing.get_context("spawn"))
    return (pool, kws, [pool.submit(_simulate, kw) for kw in kws],
            pool.submit(longrun.get_fixture, **long_kw))


def finish_prefetch(job) -> None:
    """Wait for :func:`start_prefetch`'s drives and put the fixtures into
    the memo of :func:`memoize_fixtures`."""
    pool, kws, futures, _ = job
    t0 = time.perf_counter()
    for kw, fut in zip(kws, futures):
        _FIXTURES[_fixture_key(kw)] = fut.result()
    pool.shutdown()
    print(f"fixtures: {len(kws)} drives simulated in worker processes, "
          f"waited {time.perf_counter() - t0:.1f} s for them", flush=True)


FRAMES_KW = dict(n_frames=N_FRAMES, n_rings=RINGS, n_azimuth=AZ,
                 height=IMG_H, width=IMG_W, seed=SEED)


def make_frames():
    import velo_tpu_torch as vt
    from velo_tpu_torch.lidar import rangeimage as ri_mod

    t0 = time.perf_counter()
    fx = vt.fixtures.make_fixture(**FRAMES_KW)
    lcfg = vt.config.LidarConfig(n_rings=RINGS, n_azimuth=AZ)
    grids = [ri_mod.bin_scan_host(s, lcfg) for s in fx.scans]
    print(f"fixture: {N_FRAMES} frames with images in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return fx, grids


def _bound(n_bytes: float, n_ops: float, least=roofline.least_seconds):
    """The roofline's least time of the work in ms, and what bounds it
    (``least``: ``roofline.least_seconds`` or ``least_seconds_f64``)."""
    by = "bytes" if least(n_bytes, 0) >= least(0, n_ops) else "operations"
    return 1e3 * least(n_bytes, n_ops), by


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


def _graph_nodes(fn) -> list:
    """The nodes of a CUDA graph that captures one call of ``fn``, as the
    main path captures its step: each node's label in the graph's DOT dump
    (``cudaGraphDebugDotPrint``), which names a kernel node's function."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # dumpable after capture
    with torch.cuda.graph(graph):
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    return re.findall(r'"graph_\d+_node_\d+"\s*\[(.*?)\];', dot, re.S)


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
        kernel_ms = graph_ms(lambda: dtk._launch(tt[None], tmt[None],
                                                 qt[None], K, bf))
        # Yardstick, used nowhere in the port: exact distances + top-16.
        library_ms = median_ms(lambda: torch.topk(
            torch.cdist(qt, tt), K, dim=1, largest=False))
        bound_ms, bound_by = _bound(*dist_topk_roof.call_work(q, n, K))
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
        kernel_ms = graph_ms(lambda: kl._launch(a[None], b[None], up[None],
                                                uc[None], iters))
        plain_ms = median_ms(
            lambda: kl.track_level0_reference(a, b, up, uc, vc, iters),
            bursts=7, calls=3)
        n_tmpl, n_steps, n_px = kl.work(a, b, up, uc, vc, iters)
        k = up.shape[0]
        bound_ms, bound_by = _bound(
            *klt_l0_roof.call_work(k, iters, IMG_H, IMG_W))
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


def lm_lidar_check(dev, grids) -> dict:
    """The one-launch LM solve at the path's shapes: every LM solve of the
    fixture's first LM_FRAMES LiDAR frames, stepped eagerly on the card,
    kernel against the plain solve on the card (T, accepted steps,
    convergence); for a map and a scan-to-scan solve the card ms per solve
    of the wrapper (CUDA events around eager calls), of the kernel alone
    (replayed from a CUDA graph) and of the plain solve, the wrapper calls
    and the card kernels of one call (1 each, the kernels counted as the
    nodes of a CUDA graph of the call) and the bound from bytes and float64
    operations."""
    from velo_tpu_torch.kernels import lm_lidar
    from velo_tpu_torch.kernels._timing import graph_ms, median_ms
    from velo_tpu_torch.pipeline import odometry

    cfg, _ = _cell_config("lidar")
    solves, real = [], lm_lidar.lm_lidar

    def record(*args, **kw):
        solves.append((tuple(x.clone() for x in args[:13]),
                       {k: v.clone() for k, v in kw.items() if v is not None}))
        return real(*args, **kw)

    lm_lidar.lm_lidar = record
    try:
        carry = odometry.init_carry(cfg, dev)
        for g, m in grids[:LM_FRAMES]:
            carry, _ = odometry.step(carry, torch.as_tensor(g, device=dev),
                                     torch.as_tensor(m, device=dev), cfg)
    finally:
        lm_lidar.lm_lidar = real
    if len(solves) != 9 * LM_FRAMES:
        raise AssertionError(f"lm_lidar: {len(solves)} routed solves in "
                             f"{LM_FRAMES} LiDAR frames, expected 9 each")
    differ, worst_m = 0, 0.0
    for args, q in solves:
        k = lm_lidar.lm_lidar(*args, cfg.solver, **q)
        p = lm_lidar.lm_lidar_reference(*args, cfg.solver, **q)
        if int(k.n_accept) != int(p.n_accept) or bool(
                k.converged) != bool(p.converged):
            raise AssertionError("lm_lidar: accepted steps or convergence "
                                 "differ from the plain solve")
        if not torch.equal(k.T, p.T):
            differ += 1
            worst_m = max(worst_m, (k.T - p.T).abs().max().item())
    if worst_m > 1e-6:
        raise AssertionError(f"lm_lidar: T off the plain solve by {worst_m}")
    it = cfg.solver.lm_iters
    per_solve = []
    for kind, (args, q) in (("map", next(s for s in solves if len(s[1]) == 2)),
                            ("scan", next(s for s in solves
                                          if len(s[1]) == 1))):
        ne, npl = args[3].shape[0], args[8].shape[0]

        def wrapper():
            return lm_lidar.lm_lidar(*args, cfg.solver, **q)

        _zero_launches()
        wrapper()
        calls = _launches()["lm_lidar"]
        nodes = _graph_nodes(wrapper)
        per_call = sum("lm_lidar_kernel" in n for n in nodes)
        if calls != 1 or per_call != 1 or len(nodes) != 1:
            raise AssertionError(f"one lm_lidar call: {calls} wrapper calls; "
                                 f"a graph of it holds {nodes}")
        ms = median_ms(wrapper)
        kernel_ms = graph_ms(wrapper)
        plain_ms = median_ms(
            lambda: lm_lidar.lm_lidar_reference(*args, cfg.solver, **q),
            bursts=5, calls=3)
        n_bytes, n_ops = lm_lidar_roof.call_work(
            ne, npl, "edge_q" in q, "planar_q" in q, it)
        bound_ms, bound_by = _bound(n_bytes, n_ops,
                                    roofline.least_seconds_f64)
        per_solve.append({"solve": kind, "edges": ne, "planars": npl,
                          "ms": ms, "kernel_only_ms": kernel_ms,
                          "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "wrapper_calls": calls,
                          "cuda_launches_per_call": per_call})
        print(f"lm_lidar {kind} solve ({ne} edges, {npl} planars, {it} "
              f"iterations): wrapper {ms:.4f} ms, kernel alone "
              f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by}, {n_bytes} B, {n_ops} float64 "
              f"operations); {per_call} CUDA launch per call (the one node "
              "of a CUDA graph of the call)", flush=True)
    print(f"lm_lidar: {len(solves)} solves of {LM_FRAMES} LiDAR frames, T "
          f"bitwise the plain solve's in {len(solves) - differ} (worst "
          f"{worst_m:.3g})", flush=True)
    return {"per_shape": per_solve, "solves": len(solves),
            "t_bitwise": len(solves) - differ, "max_abs_err": worst_m}


def lm_joint_check(dev, fx, grids) -> dict:
    """The one-launch joint LM solve at the path's shapes: every joint
    solve (the 5 + 1 scan-to-scan solves, which carry the visual blocks) of
    the fixture's first LM_FRAMES fused frames, stepped eagerly on the
    card, kernel against the plain solve on the card (T, accepted steps,
    convergence); for the richest solve (most depth tracks) the card ms of
    the wrapper, of the kernel alone (replayed from a CUDA graph) and of
    the plain solve, and the wrapper calls and card kernels of one call (1
    each)."""
    from velo_tpu_torch.geom import camera
    from velo_tpu_torch.kernels import lm_joint
    from velo_tpu_torch.kernels._timing import graph_ms, median_ms
    from velo_tpu_torch.pipeline import odometry
    from velo_tpu_torch.solve import icp

    cfg, _ = _cell_config("fused")
    cam = camera.from_numpy(fx.P, fx.T_cam_velo, IMG_W, IMG_H, dev)
    solves, real = [], lm_joint.lm_joint

    def clone(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def record(*args, prepared=None, **kw):
        solves.append((tuple(x.clone() for x in args[:13]),
                       icp.VisData(*(clone(x) for x in args[13])),
                       {k: v.clone() for k, v in kw.items() if v is not None}))
        return real(*args, prepared=prepared, **kw)

    lm_joint.lm_joint = record
    try:
        carry = odometry.init_carry(cfg, dev)
        for (g, m), img in zip(grids[:LM_FRAMES], fx.images[:LM_FRAMES]):
            carry, _ = odometry.step(
                carry, torch.as_tensor(g, device=dev),
                torch.as_tensor(m, device=dev), cfg, cam=cam,
                image=torch.as_tensor(np.asarray(img, np.float32),
                                      device=dev))
    finally:
        lm_joint.lm_joint = real
    if len(solves) != 6 * LM_FRAMES:
        raise AssertionError(f"lm_joint: {len(solves)} routed solves in "
                             f"{LM_FRAMES} fused frames, expected 6 each")
    differ, worst_m = 0, 0.0
    for args, vis, q in solves:
        k = lm_joint.lm_joint(*args, vis, cfg.solver, **q)
        p = lm_joint.lm_joint_reference(*args, vis, cfg.solver, **q)
        if int(k.n_accept) != int(p.n_accept) or bool(
                k.converged) != bool(p.converged):
            raise AssertionError("lm_joint: accepted steps or convergence "
                                 "differ from the plain solve")
        if not torch.equal(k.T, p.T):
            differ += 1
            worst_m = max(worst_m, (k.T - p.T).abs().max().item())
    if worst_m > 1e-6:
        raise AssertionError(f"lm_joint: T off the plain solve by {worst_m}")
    args, vis, q = max(solves, key=lambda s: (int(s[1].mask.sum()),
                                              int(s[1].mask_nodepth.sum())))
    prep = lm_joint.prepare(vis, cfg.solver)

    def wrapper():  # the pose-free inputs made once per solve, as _solve does
        return lm_joint.lm_joint(*args, vis, cfg.solver, **q, prepared=prep)

    _zero_launches()
    wrapper()
    calls = _launches()["lm_joint"]
    nodes = _graph_nodes(wrapper)
    per_call = sum("lm_joint_kernel" in n for n in nodes)
    if calls != 1 or per_call != 1 or len(nodes) != 1:
        raise AssertionError(f"one lm_joint call: {calls} wrapper calls; "
                             f"a graph of it holds {nodes}")
    ms = median_ms(wrapper)
    kernel_ms = graph_ms(wrapper)
    plain_ms = median_ms(
        lambda: lm_joint.lm_joint_reference(*args, vis, cfg.solver, **q),
        bursts=5, calls=3)
    ne, npl, nt = args[3].shape[0], args[8].shape[0], vis.mask.shape[0]
    nd, nn = int(vis.mask.sum()), int(vis.mask_nodepth.sum())
    it = cfg.solver.lm_iters
    n_bytes, n_ops = lm_lidar_roof.call_work(ne, npl, False, True, it)
    n_bytes += nt * LM_TRACK_BYTES + LM_CAMERA_BYTES
    n_ops += it * nt * LM_TRACK_F64_OPS
    bound_ms, bound_by = _bound(n_bytes, n_ops, roofline.least_seconds_f64)
    print(f"lm_joint scan solve ({ne} edges, {npl} planars, {nt} tracks: "
          f"{nd} with depth, {nn} without; {it} iterations): wrapper "
          f"{ms:.4f} ms, kernel alone {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}, "
          f"{n_bytes} B, {n_ops} float64 operations); {calls} wrapper call, "
          f"{per_call} CUDA launch per call (the one node of a CUDA graph "
          "of the call)", flush=True)
    print(f"lm_joint: {len(solves)} solves of {LM_FRAMES} fused frames, T "
          f"bitwise the plain solve's in {len(solves) - differ} (worst "
          f"{worst_m:.3g})", flush=True)
    return {"per_shape": [{"solve": "scan", "edges": ne, "planars": npl,
                           "depth_tracks": nd, "nodepth_tracks": nn,
                           "ms": ms, "kernel_only_ms": kernel_ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "wrapper_calls": calls,
                           "cuda_launches_per_call": per_call}],
            "solves": len(solves), "t_bitwise": len(solves) - differ,
            "max_abs_err": worst_m}


def _fit_bytes(args, line) -> int:
    """Bytes of one ``corr_fit`` call: each input read once (points,
    validity, rings for the 2-point lines, queries, masks) and each output
    written once."""
    edge, pe, _, planar, pp, _ = args[:6]
    total = 0
    for rows, q, out_f32 in ((edge, pe.shape[0], 7),
                             (planar, pp.shape[0], 5)):
        c = rows.pts.shape[1]
        total += q * c * (12 + 1) + q * (12 + 1)  # rows, ok; queries, mask
        total += q * (out_f32 * 4 + 1)  # float32 outputs and ok
    if not line:
        total += pe.shape[0] * edge.pts.shape[1] * 4  # rings
    return total


def corr_fit_check(dev, grids) -> dict:
    """The one-launch correspondence fit at the path's shapes: every fit of
    the fixture's first LM_FRAMES LiDAR frames, dense engine and hash
    engine, stepped eagerly on the card, kernel against its plain version
    on the card (all outputs bitwise); for a scan-to-scan (2-point lines)
    and a map (PCA lines) fit of each engine the card ms per call of the
    wrapper (CUDA events around eager calls), of the kernel alone (20
    calls replayed from a CUDA graph) and of the plain version, the wrapper
    calls and the card kernels of one call (1 each, the kernels counted as
    the nodes of a CUDA graph of the call) and the bound from its bytes
    (its operations are not counted)."""
    from velo_tpu_torch.kernels import corr_fit
    from velo_tpu_torch.kernels._timing import graph_ms, median_ms
    from velo_tpu_torch.pipeline import odometry

    def clone(x):
        if isinstance(x, corr_fit.Rows):
            return x._replace(pts=x.pts.clone(), payload=x.payload.clone(),
                              ok=x.ok.clone())
        return x.clone() if isinstance(x, torch.Tensor) else x

    def bitwise(a, b) -> bool:
        return all((x is None and y is None) or torch.equal(
            x.view(torch.int32) if x.is_floating_point() else x,
            y.view(torch.int32) if y.is_floating_point() else y)
            for x, y in zip(a, b))

    real, per_call, n_fits = corr_fit.corr_fit, [], 0
    for mode in ("lidar", "hash"):
        cfg, _ = _cell_config(mode)
        calls = []

        def record(*args, line=False):
            calls.append((tuple(clone(x) for x in args), line))
            return real(*args, line=line)

        corr_fit.corr_fit = record
        try:
            carry = odometry.init_carry(cfg, dev)
            for g, m in grids[:LM_FRAMES]:
                carry, _ = odometry.step(
                    carry, torch.as_tensor(g, device=dev),
                    torch.as_tensor(m, device=dev), cfg)
        finally:
            corr_fit.corr_fit = real
        if len(calls) != 9 * LM_FRAMES:
            raise AssertionError(f"corr_fit {mode}: {len(calls)} fits in "
                                 f"{LM_FRAMES} LiDAR frames, expected 9 each")
        for i, (args, line) in enumerate(calls):
            if not bitwise(real(*args, line=line),
                           corr_fit.corr_fit_reference(*args, line=line)):
                raise AssertionError(f"corr_fit {mode}: fit {i} differs from "
                                     "its plain version")
        n_fits += len(calls)
        for kind, line in (("scan", False), ("map", True)):
            args = [a for a, ln in calls if ln == line][-1]

            def wrapper():
                return real(*args, line=line)

            _zero_launches()
            wrapper()
            n_calls = _launches()["corr_fit"]
            nodes = _graph_nodes(wrapper)
            per_launch = sum("corr_fit_kernel" in n for n in nodes)
            if n_calls != 1 or per_launch != 1 or len(nodes) != 1:
                raise AssertionError(f"one corr_fit call: {n_calls} wrapper "
                                     f"calls; a graph of it holds {nodes}")
            ms = median_ms(wrapper)
            kernel_ms = graph_ms(wrapper)
            plain_ms = median_ms(
                lambda: corr_fit.corr_fit_reference(*args, line=line),
                bursts=5, calls=3)
            n_bytes = _fit_bytes(args, line)
            bound_ms, bound_by = _bound(n_bytes, 0)
            qe, qp = args[1].shape[0], args[4].shape[0]
            per_call.append({"engine": mode, "fit": kind, "edges": qe,
                             "planars": qp, "candidates":
                             args[0].pts.shape[1], "ms": ms,
                             "kernel_only_ms": kernel_ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by + " (operations not "
                             "counted)", "wrapper_calls": n_calls,
                             "cuda_launches_per_call": per_launch})
            print(f"corr_fit {mode} {kind} fit ({qe} edges, {qp} planars, "
                  f"C = {args[0].pts.shape[1]}): wrapper {ms:.4f} ms, "
                  f"kernel alone {kernel_ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, bound {bound_ms:.6f} ms ({n_bytes} B); {per_launch} "
                  "CUDA launch per call", flush=True)
    print(f"corr_fit: {n_fits} fits of {LM_FRAMES} LiDAR frames (dense and "
          "hash), each bitwise its plain version", flush=True)
    return {"per_shape": per_call, "fits": n_fits, "max_abs_err": 0.0}


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


def _device_time(prof):
    """(summed card kernel seconds, kernel count, seconds of each of the
    port's kernels, launches of each) of a torch.profiler run, read
    from the raw Kineto events: ``prof.events()`` would first build a
    Python object for each of the ~0.5 million events of a profiled step,
    which took a minute a frame on the card's host.  The profiler sees the
    kernels inside a replayed CUDA graph one by one.  The device-side copy
    of a program's ``velo.*`` profiler range spans the work it launched
    and is not counted."""
    busy, n = 0.0, 0
    own = dict.fromkeys(KERNELS, 0.0)
    count = dict.fromkeys(KERNELS, 0)
    for ev in prof.profiler.kineto_results.events():
        if (ev.device_type() == torch.autograd.DeviceType.CUDA
                and not ev.name().startswith("velo.")):
            dt = ev.duration_ns() * 1e-9
            busy += dt
            n += 1
            for key in own:
                if key in ev.name():
                    own[key] += dt
                    count[key] += 1
    return busy, n, own, count


def _profile_calls(fn) -> dict:
    """torch.profiler over ``fn()``: wall, card kernel time and count, busy
    share, and the port's kernels' seconds and launches (also inside
    replayed graphs)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, n, own, count = _device_time(prof)
    return {"wall_s": wall, "device_s": busy, "kernels": n,
            "busy_share": busy / wall,
            **{f"{k}_s": v for k, v in own.items()}, "launches": count}


def _profile(frames, cfg, carry, cam) -> dict:
    """:func:`_profile_calls` over ``run_sequence`` of 2 frames from a warm
    carry."""
    from velo_tpu_torch.pipeline import odometry

    return {"frames": len(frames), **_profile_calls(
        lambda: odometry.run_sequence(frames, cfg, carry=carry, cam=cam))}


def _gate_m(mode) -> float:
    return GATE_GT_M_CT if mode == "ct-fused" else GATE_GT_M


def _cell_config(mode):
    """(config, fused) of a fixture cell: "fused" (level 0 through
    ``klt_l0``), "fused-gather" (the shipped ``klt_impl="auto"``, level 0
    on the gather sampler), "lidar", or one of ``VARIANTS``."""
    import velo_tpu_torch as vt

    fused = mode in ("fused", "fused-gather") or (
        mode in VARIANTS and VARIANTS[mode][0])
    cfg = vt.config.VeloConfig(
        lidar=vt.config.LidarConfig(n_rings=RINGS, n_azimuth=AZ),
        vision=vt.config.VisionConfig(
            height=IMG_H, width=IMG_W,
            klt_impl="auto" if mode == "fused-gather" else "pallas"),
        use_vision=fused, use_map=True, prebin_host=True)
    if mode in VARIANTS:
        cfg = vt.config.apply_overrides(cfg, VARIANTS[mode][1])
    return cfg, fused


def pipeline_run(dev, mode, fx, grids) -> dict:
    """One cell (see :func:`_cell_config`): launches, ground truth, card
    against CPU (all frames; frames 0-1 for a variant; none for
    fused-gather), warm frames/s and, for the two fused cells, a
    profile.  On the card ``run_sequence`` replays the step from CUDA
    graphs, captured afresh for the cell.  Returns (result, the CPU run's
    poses or None)."""
    from velo_tpu_torch.geom import camera
    from velo_tpu_torch.pipeline import graphs, odometry

    cfg, fused = _cell_config(mode)
    frames = ([g + (img,) for g, img in zip(grids, fx.images)] if fused
              else grids)
    cam = (camera.from_numpy(fx.P, fx.T_cam_velo, IMG_W, IMG_H, dev)
           if fused else None)

    graphs.release()
    _zero_launches()
    poses, diags, carry = odometry.run_sequence(frames, cfg, device=dev,
                                                cam=cam)
    torch.cuda.synchronize()
    launches = _launches()
    per_frame = (VARIANTS[mode][2:] if mode in VARIANTS
                 else (4, 2 if mode == "fused" else 0,
                       LM_FUSED if fused else LM_LIDAR))
    _expect_launches(mode, launches, *per_frame)
    captures = [c._asdict() for c in graphs.captures()]
    if not all(x.is_cuda for x in _carry_leaves(carry)):
        raise AssertionError(f"{mode}: carry left the card")
    if not np.all(np.isfinite(poses)) or poses.shape != (N_FRAMES, 4, 4):
        raise AssertionError(f"{mode}: bad poses: shape {poses.shape}")

    gt = np.linalg.inv(fx.gt_poses_velo[0]) @ fx.gt_poses_velo
    gt_t, gt_r = _pose_errors(poses, gt)
    print(f"{mode}: launches {launches}; pose error vs ground truth per "
          f"frame {np.round(gt_t, 4).tolist()} m, "
          f"{np.round(gt_r, 4).tolist()} deg; max {gt_t.max():.4f} m, "
          f"{gt_r.max():.4f} deg (gates {_gate_m(mode)} m, "
          f"{GATE_GT_DEG[mode]} deg); n_depth {diags['n_depth'].tolist()}", flush=True)
    if gt_t.max() > _gate_m(mode) or gt_r.max() > GATE_GT_DEG[mode]:
        raise AssertionError(f"{mode}: pose error vs ground truth above the "
                             "gate")

    n_cpu = VARIANT_CPU_FRAMES if mode in VARIANTS else N_FRAMES
    cpu, cpu_poses = _cpu_compare(
        mode, frames[:n_cpu], cfg, cam, poses[:n_cpu],
        {k: v[:n_cpu] for k, v in diags.items()}) \
        if mode != "fused-gather" else ({}, None)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, warm = odometry.run_sequence(frames, cfg, device=dev, cam=cam)
    torch.cuda.synchronize()
    fps = N_FRAMES / (time.perf_counter() - t0)
    print(f"{mode}: warm pass {fps:.3f} frames/s", flush=True)
    prof = (_profile(frames[:2], cfg, warm, cam)
            if mode in ("fused", "fused-gather") else None)
    if prof is not None:
        print(f"{mode}: profile of 2 warm frames: {prof}", flush=True)
        replayed = {k: v / 2 for k, v in prof["launches"].items()}
        if replayed != _per_frame(*per_frame):
            raise AssertionError(f"{mode}: launches per replayed frame "
                                 f"{replayed}")
    graphs.release()
    return {"mode": mode, "launches": launches, "captures": captures,
            "fps": fps, "gt_err_m": float(gt_t.max()),
            "gt_err_deg": float(gt_r.max()), **cpu,
            "n_depth": diags["n_depth"].tolist(), "profile": prof}, cpu_poses


def _step_through(step, carry, frames):
    """Run ``step`` over ``frames`` (tensors on the card) -> (host seconds
    of each step call, the carry entering each frame, the final carry,
    the wall seconds to the last frame's end).  A call's host time is its
    enqueue time: the loop never waits for the card."""
    host, carries = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fr in frames:
        carries.append(carry)
        h0 = time.perf_counter()
        carry, _ = step(carry, *fr)
        host.append(time.perf_counter() - h0)
    torch.cuda.synchronize()
    return host, carries, carry, time.perf_counter() - t0


def _timed_frames(step, carry, frames) -> dict:
    """:func:`_step_through` as frames/s, wall, the host's mean ms per
    call and the final carry."""
    host, _, carry, wall = _step_through(step, carry, frames)
    return {"fps": len(frames) / wall, "wall_s": wall,
            "host_ms_per_frame": 1e3 * float(np.mean(host)), "carry": carry}


def run_scan_phase(dev, fx, grids, cpu_poses, smi) -> dict:
    """This slice's path, ``odometry.run_scan`` (one CUDA-graph replay per
    frame), fused (``klt_l0`` at level 0) and LiDAR-only at full width:
    bitwise against the eager ``step`` loop on the card and against the
    CPU run of the cells above; wrapper calls (each graph's warm-up and
    capture) and the launches inside the replays (profiler, per frame);
    graphs captured and their seconds; warm frames/s, host ms per frame and
    busy share, captured beside eager."""
    from velo_tpu_torch.geom import camera
    from velo_tpu_torch.pipeline import graphs, odometry

    out = {}
    for mode in ("fused", "lidar"):
        cfg, fused = _cell_config(mode)
        per_frame = (4, 2, LM_FUSED) if fused else (4, 0, LM_LIDAR)
        cam = (camera.from_numpy(fx.P, fx.T_cam_velo, IMG_W, IMG_H, dev)
               if fused else None)
        scans = torch.as_tensor(np.stack([g[0] for g in grids])).to(dev)
        masks = torch.as_tensor(np.stack([g[1] for g in grids])).to(dev)
        images = (torch.as_tensor(np.stack(fx.images)).to(dev) if fused
                  else None)
        frames = [(scans[f], masks[f], None if images is None
                   else images[f]) for f in range(N_FRAMES)]

        def eager(carry, scan, mask, image):
            return odometry.step(carry, scan, mask, cfg, image=image,
                                 cam=cam)

        def captured(carry, scan, mask, image):
            return odometry.jit_step(carry, scan, mask, cfg, image=image,
                                     cam=cam)

        # The eager loop (warm: the cells above ran its warm-ups), timed,
        # its results kept; then a profile.
        outs = []

        def kept(carry, *fr):
            carry, o = eager(carry, *fr)
            outs.append(o)
            return carry, o

        eager_t = _timed_frames(kept, odometry.init_carry(cfg, dev), frames)
        carry = eager_t.pop("carry")
        ref = odometry.stack_results(outs)
        eager_p = _profile_calls(lambda: _timed_frames(
            eager, odometry.init_carry(cfg, dev), frames[:2]))
        # The profiler slows the host: the card's share of an unprofiled
        # warm frame is its kernel time per frame over that frame's wall.
        for t, p in ((eager_t, eager_p),):
            t["busy_share_warm"] = p["device_s"] / 2 * t["fps"]

        # The captured run, from nothing captured.
        graphs.release()
        _zero_launches()
        t0 = time.perf_counter()
        final, res = odometry.run_scan(odometry.init_carry(cfg, dev), scans,
                                       masks, cfg, images=images, cam=cam)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = _launches()
        _expect_launches(f"run-scan {mode}", launches, *per_frame)
        captures = [c._asdict() for c in graphs.captures()]
        differ = [k for k in res._fields
                  if not torch.equal(getattr(res, k), getattr(ref, k))]
        if differ:
            raise AssertionError(f"run-scan {mode}: captured and eager "
                                 f"differ in {differ}")
        if not torch.equal(final.T_w, carry.T_w) or not torch.equal(
                final.edge_map.pts, carry.edge_map.pts):
            raise AssertionError(f"run-scan {mode}: final carries differ")
        n_cpu = len(cpu_poses[mode])
        if not np.array_equal(res.T_w.cpu().numpy()[:n_cpu],
                              cpu_poses[mode]):
            raise AssertionError(f"run-scan {mode}: not the CPU run's poses")
        graph_t = _timed_frames(captured, odometry.init_carry(cfg, dev),
                                frames)
        del graph_t["carry"]
        graph_p = _profile_calls(lambda: _timed_frames(
            captured, odometry.init_carry(cfg, dev), frames[:2]))
        graph_t["busy_share_warm"] = graph_p["device_s"] / 2 * graph_t["fps"]
        replayed = {k: v / 2 for k, v in graph_p["launches"].items()}
        if replayed != _per_frame(*per_frame):
            raise AssertionError(f"run-scan {mode}: launches per replayed "
                                 f"frame {replayed}")
        graphs.release()
        out[mode] = {
            "launches": launches, "launches_per_replayed_frame": replayed,
            "bitwise_vs_eager": True, "bitwise_vs_cpu_frames": n_cpu,
            "captures": captures, "first_run_s": first_s,
            "captured": {**graph_t, "profile_2_frames": graph_p},
            "eager": {**eager_t, "profile_2_frames": eager_p}}
        print(f"run-scan {mode}: {len(captures)} graphs captured "
              f"({[round(c['warm_s'] + c['capture_s'], 2) for c in captures]}"
              f" s with warm-up), bitwise equal to the eager loop and to the "
              f"CPU on frames 0-{n_cpu - 1}; wrapper calls {launches}, "
              f"launches per replayed frame {replayed}; warm "
              f"{graph_t['fps']:.3f} against eager {eager_t['fps']:.3f} "
              f"frames/s, host {graph_t['host_ms_per_frame']:.2f} against "
              f"{eager_t['host_ms_per_frame']:.2f} ms per frame, busy "
              f"{graph_t['busy_share_warm']:.4f} against "
              f"{eager_t['busy_share_warm']:.4f} of a warm frame "
              f"({graph_p['busy_share']:.4f} against "
              f"{eager_p['busy_share']:.4f} under the profiler), card "
              f"{graph_p['device_s'] / 2:.4f} against "
              f"{eager_p['device_s'] / 2:.4f} s per frame, on {smi}",
              flush=True)
    return out


def _cpu_compare(mode, frames, cfg, cam, poses, diags) -> dict:
    """The same frames through the port's CPU path (plain kernels)."""
    from velo_tpu_torch.pipeline import odometry

    t0 = time.perf_counter()
    cpu_poses, cpu_diags, _ = odometry.run_sequence(frames, cfg,
                                                    device="cpu", cam=cam)
    cpu_t, cpu_r = _pose_errors(poses, cpu_poses)
    bitwise = bool(np.array_equal(poses, cpu_poses))
    for f in range(len(frames)):
        print(f"{mode} frame {f}: card vs CPU {cpu_t[f]:.6f} m, "
              f"{cpu_r[f]:.6f} deg", flush=True)
    print(f"{mode}: card vs CPU over {len(frames)} frames: max "
          f"{cpu_t.max():.6f} m, {cpu_r.max():.6f} deg, poses bitwise equal: "
          f"{bitwise}, n_depth equal: "
          f"{bool(np.array_equal(diags['n_depth'], cpu_diags['n_depth']))} "
          f"(CPU run {time.perf_counter() - t0:.1f} s)", flush=True)
    if cpu_t.max() > GATE_CPU_M or cpu_r.max() > GATE_CPU_DEG:
        raise AssertionError(f"{mode}: card and CPU poses disagree")
    return {"cpu_diff_m": float(cpu_t.max()),
            "cpu_diff_deg": float(cpu_r.max()),
            "cpu_bitwise": bitwise}, cpu_poses


def _cli(argv, device=None):
    """``velo_tpu_torch.cli.main(argv + ["--json"])`` in process, on the
    card unless ``device`` says otherwise -> (the --json line's result,
    what it wrote to stderr, the kernels' launch counts of this call)."""
    from velo_tpu_torch import cli
    from velo_tpu_torch.pipeline import graphs

    out, err = io.StringIO(), io.StringIO()
    graphs.release()  # this run captures its own graphs
    _zero_launches()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv + ["--json"]
                      + (["--device", device] if device else []))
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"cli.main({argv}) returned {rc}")
    launches = _launches()
    if device == "cpu" and any(launches.values()):
        raise AssertionError(f"a CPU run launched kernels: {launches}")
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue(), launches


_launch_base: dict = {}


def _kernel_launches() -> dict:
    """Each of ``KERNELS``'s launches so far in this process, from its
    ``kernel.<name>`` counter (a batched call is one)."""
    from velo_tpu_torch.evaluation import profiling

    c = profiling.counters()
    return {k: c.get(f"kernel.{k}", (0, 0.0))[0] for k in KERNELS}


def _zero_launches() -> None:
    """Take the snapshot of the counters that :func:`_launches` reads
    from."""
    _launch_base.update(_kernel_launches())


def _launches() -> dict:
    """The launches (wrapper calls) of the port's kernels since
    :func:`_zero_launches`."""
    return {k: n - _launch_base.get(k, 0)
            for k, n in _kernel_launches().items()}


def _per_frame(dist_per_frame, klt_per_frame, lm_per_frame) -> dict:
    """Launches per frame of each of ``KERNELS``; ``lm_per_frame`` is
    (lm_lidar, lm_joint, corr_fit)."""
    return dict(zip(KERNELS, (dist_per_frame, klt_per_frame, *lm_per_frame)))


def _graph_calls(dist_per_frame, klt_per_frame, lm_per_frame,
                 eager_dist=0, eager_corr=0) -> dict:
    """The wrapper calls a run on the card makes since the last
    ``graphs.release()``: each CUDA graph it captured runs the step once
    eagerly (its warm-up) and once under capture, and a replay calls no
    wrapper; ``eager_dist`` and ``eager_corr`` add eager ``dist_topk`` and
    ``corr_fit`` calls outside the graphs (the smoother's).  The launches
    inside the replays are counted from a profile (:func:`_device_time`).
    """
    from velo_tpu_torch.pipeline import graphs

    n = 2 * len(graphs.captures())
    calls = {k: v * n for k, v in _per_frame(
        dist_per_frame, klt_per_frame, lm_per_frame).items()}
    calls["dist_topk"] += eager_dist
    calls["corr_fit"] += eager_corr
    return calls


def _expect_launches(what, launches, dist_per_frame, klt_per_frame,
                     lm_per_frame, eager_dist=0, eager_corr=0):
    """The wrapper calls of a run against :func:`_graph_calls`, with at
    least one graph captured where a kernel runs at all."""
    expect = _graph_calls(dist_per_frame, klt_per_frame, lm_per_frame,
                          eager_dist, eager_corr)
    per_frame = _per_frame(dist_per_frame, klt_per_frame, lm_per_frame)
    if launches != expect or any(
            k and not launches[name] for name, k in per_frame.items()):
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
    from velo_tpu_torch.io import kitti, native_loader
    from velo_tpu_torch.pipeline import checkpoint, graphs, odometry, smoother

    def path(*parts):
        return os.path.join(tmp, *parts)

    base = ["--kitti-root", root, "--seq", "00", "--set", KITTI_SET]
    every = ["--checkpoint-every", str(N_FRAMES // 2)]
    gt = kitti.read_poses(os.path.join(root, "poses", "00.txt"))

    # The uninterrupted run: forward, then the smoother.
    res, err, launches = _cli(
        base + ["--frames", str(N_FRAMES), "--out", path("smooth"),
                "--checkpoint", path("ck.npz"), "--smooth"] + every)
    _expect_launches("cli-kitti", launches, 4, 2, LM_FUSED,
                     eager_dist=2 * N_FRAMES * SMOOTH_PASSES,
                     eager_corr=SMOOTH_CORR)
    # The native prefetch loader read the scans, binning them in its
    # workers; not the Python fallback.
    if "scan reader: native-binned\n" not in err:
        raise AssertionError("cli-kitti: the scan reader was not "
                             f"native-binned: {err[-2000:]}")
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
    _expect_launches("cli-kitti, first half", n_half, 4, 2, LM_FUSED)
    if checkpoint.checkpoint_frame(path("ck2.npz")) != half:
        raise AssertionError("cli-kitti: no checkpoint at the interruption")
    res_r, _, n_res = _cli(
        base + ["--frames", str(N_FRAMES), "--out", path("resumed"),
                "--checkpoint", path("ck2.npz"), "--resume"] + every)
    _expect_launches("cli-kitti, resumed", n_res, 4, 2, LM_FUSED)
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
    # The frames as the command line read them: the native loader's grids
    # (their phases differ from bin_scan_host's in the last bit, see the
    # loader phase).
    grids = list(native_loader.NativeBinnedScanLoader(
        seq.velo_dir, lcfg.lidar, n_max=lcfg.n_max_points))[:N_FRAMES]
    scans = np.stack([g[0] for g in grids])
    masks = np.stack([g[1] for g in grids])
    poses, pass_s, per_pass = full["poses"], [], []
    _zero_launches()
    for _ in range(SMOOTH_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses = smoother.smooth_trajectory(
            scans, masks, poses, lcfg, window=SMOOTH_WINDOW, passes=1,
            device=dev)
        torch.cuda.synchronize()
        pass_s.append(time.perf_counter() - t0)
        per_pass.append(poses)
    graphs.release()  # the smoother's passes run eagerly
    # Its scan-to-map solves carry no motion prior: the plain LM path; each
    # outer iteration's fit is one corr_fit launch.
    _expect_launches("smoother", _launches(), 0, 0, LM_NONE,
                     eager_dist=2 * N_FRAMES * SMOOTH_PASSES,
                     eager_corr=SMOOTH_CORR)
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
        _expect_launches(f"cli {name}", launches, 4, 0,
                         LM_FAST if name == "fast" else LM_LIDAR)
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


def _gil_wait_ms(fn, repeat):
    """Run ``fn`` ``repeat`` times in a second thread while this thread
    runs Python; return (ms per call that this thread was kept from
    running, its longest wait in ms).  A gap of over 0.2 ms between two of
    this thread's steps counts as waiting; ``fn=None`` measures the gaps of
    this thread alone over ``repeat`` ms (the host's own noise; their sum,
    not per call)."""
    import threading

    if fn is None:
        th = threading.Thread(target=time.sleep, args=(repeat * 1e-3,))
        repeat = 1
    else:
        th = threading.Thread(target=lambda: [fn() for _ in range(repeat)])
    stamps = [time.perf_counter()]
    th.start()
    while th.is_alive():
        stamps.append(time.perf_counter())
    th.join()
    gaps = np.diff(np.asarray(stamps))
    waits = gaps[gaps > 2e-4]
    return (1e3 * float(waits.sum()) / repeat,
            1e3 * float(waits.max(initial=0.0)))


def png_phase(tmp, smi) -> dict:
    """A KITTI-sized (1241 x 376) 8-bit PNG written with mixed scanline
    filters (Sub / Average / Paeth / Up / None by row): the native
    unfilter byte for byte against the Python loop it replaced, the time
    per frame of both and of ``read_gray8``, and how long a second Python
    thread waits while each decodes (the native call releases the GIL)."""
    from velo_tpu_torch.io import png

    h, w = 376, 1241
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.clip(128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
                  + rng.normal(0, 20, (h, w)), 0, 255).astype(np.uint8)
    filters = np.array([1, 3, 4, 2, 0])[np.arange(h) % 5]
    path = os.path.join(tmp, "mixed.png")
    png.write_gray8(path, img, filters=filters)
    raw = png._filter_rows(img, filters)
    native = png._unfilter(raw, h, w, path)
    t0 = time.perf_counter()
    plain = png._unfilter_reference(raw, h, w, path)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    if not (np.array_equal(native, plain) and np.array_equal(native, img)
            and np.array_equal(png.read_gray8(path), img)):
        raise AssertionError("png: the native unfilter differs from the "
                             "Python loop or the image")

    def per_call_ms(fn, n):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return 1e3 * (time.perf_counter() - t0) / n

    native_ms = per_call_ms(lambda: png._unfilter(raw, h, w, path), 50)
    read_ms = per_call_ms(lambda: png.read_gray8(path), 20)
    wait_native = _gil_wait_ms(lambda: png._unfilter(raw, h, w, path), 50)
    wait_plain = _gil_wait_ms(
        lambda: png._unfilter_reference(raw, h, w, path), 1)
    # The host's own gaps over as long as the 50 native decodes took, per
    # decode.
    noise = _gil_wait_ms(None, 50 * native_ms)
    noise = (noise[0] / 50, noise[1])
    print(f"png {w}x{h} mixed filters: native unfilter byte-equal to the "
          f"Python loop; unfilter {native_ms:.3f} ms native, {plain_ms:.1f} "
          f"ms Python; read_gray8 {read_ms:.3f} ms per frame; a second "
          f"Python thread waits {wait_native[0]:.3f} ms per native decode "
          f"(longest wait {wait_native[1]:.3f} ms; alone, over the same "
          f"time: {noise[0]:.3f} ms per decode, longest {noise[1]:.3f} ms), "
          f"{wait_plain[0]:.1f} ms per Python decode (longest "
          f"{wait_plain[1]:.1f} ms); host of {smi}", flush=True)
    return {"unfilter_native_ms": native_ms, "unfilter_python_ms": plain_ms,
            "read_gray8_ms": read_ms, "gil_wait_native_ms": wait_native[0],
            "gil_wait_native_longest_ms": wait_native[1],
            "gil_wait_alone_ms": noise[0],
            "gil_wait_python_ms": wait_plain[0],
            "gil_wait_python_longest_ms": wait_plain[1],
            "bytes_equal": True}


def loader_phase(root) -> dict:
    """``NativeBinnedScanLoader`` over the exported KITTI directory at the
    command line's KITTI configuration (HDL-64E beam table, sweep start at
    the rear): valid masks equal to ``rangeimage.bin_scan_host``'s, grids
    within 1e-6 (the reference's own bound), ms per frame against the
    Python reader with ``bin_scan_host``."""
    from velo_tpu_torch.config import LidarConfig, VeloConfig
    from velo_tpu_torch.io import kitti, native_loader
    from velo_tpu_torch.lidar import rangeimage as ri_mod

    cfg = VeloConfig(lidar=LidarConfig(n_rings=RINGS, n_azimuth=AZ,
                                       ring_mode="hdl64e",
                                       az_start=float(np.pi)))
    velo_dir = os.path.join(root, "sequences", "00", "velodyne")
    t0 = time.perf_counter()
    loader = native_loader.NativeBinnedScanLoader(velo_dir, cfg.lidar,
                                                  n_max=cfg.n_max_points)
    got = list(loader)
    loader.close()
    native_ms = 1e3 * (time.perf_counter() - t0) / len(got)
    t0 = time.perf_counter()
    ref = [ri_mod.bin_scan_host(kitti.read_velodyne_bin(os.path.join(
        velo_dir, f"{i:06d}.bin")), cfg.lidar) for i in range(len(got))]
    python_ms = 1e3 * (time.perf_counter() - t0) / len(got)
    if len(got) != N_FRAMES:
        raise AssertionError(f"loader: {len(got)} frames")
    worst, bitwise = 0.0, []
    for (grid, valid), (rg, rv) in zip(got, ref):
        if not np.array_equal(valid, rv):
            raise AssertionError("loader: valid masks differ")
        worst = max(worst, float(np.abs(grid - rg).max()))
        bitwise.append(bool(np.array_equal(grid, rg)))
    if worst > 1e-6:
        raise AssertionError(f"loader: grids differ by {worst}")
    print(f"loader: {N_FRAMES} frames {RINGS} x {AZ} binned in C++ workers, "
          f"valid masks equal, grids within {worst:.3g} of bin_scan_host "
          f"(bitwise {bitwise}); {native_ms:.2f} ms per frame, Python reader "
          f"+ bin_scan_host {python_ms:.2f} ms", flush=True)
    return {"native_ms_per_frame": native_ms,
            "python_ms_per_frame": python_ms, "max_abs_err": worst,
            "bitwise": bitwise}


def batch_fixture_kws():
    """The drives the command line's --batch simulates (with images: the
    LiDAR-only run takes the same scans from the memo)."""
    return [dict(n_frames=BATCH_FRAMES, n_rings=RINGS, n_azimuth=AZ,
                 with_images=True, height=BATCH_H, width=BATCH_W,
                 seed=100 + b) for b in range(BATCH)]


def _first_difference(batched, single, diag_b, diag_s):
    """(frame, field) where a batched sequence first differs from its
    single-sequence run, or None."""
    fields = [("T_w", batched, single)] + [
        (k, diag_b[k], diag_s[k]) for k in diag_s]
    for f in range(len(single)):
        for name, a, b in fields:
            if not np.array_equal(a[f], b[f]):
                return f, name
    return None


def _hold_equal(what, batched, single, diag_b, diag_s) -> dict:
    """Bitwise, or else report where and hold to 5 cm / 0.1 deg."""
    first = _first_difference(batched, single, diag_b, diag_s)
    dt, dr = _pose_errors(batched, single)
    if first is None:
        print(f"{what}: bitwise equal (poses and every diagnostic)",
              flush=True)
    else:
        print(f"{what}: NOT bitwise: first at frame {first[0]}, field "
              f"{first[1]}; poses differ by up to {dt.max():.6f} m, "
              f"{dr.max():.6f} deg", flush=True)
        if dt.max() > GATE_CPU_M or dr.max() > GATE_CPU_DEG:
            raise AssertionError(f"{what}: beyond 5 cm / 0.1 deg")
    return {"bitwise": first is None, "first_difference": first,
            "diff_m": float(dt.max()), "diff_deg": float(dr.max())}


def _sequence_frames(bi, b):
    return [(bi.scans[b, f], bi.masks[b, f])
            + ((bi.images[b, f],) if bi.cfg.use_vision else ())
            for f in range(bi.scans.shape[1])]


def batch_cli(dev, tmp, smi) -> dict:
    """``--batch 4`` through the command line in process, fused (klt_l0 at
    level 0) and LiDAR-only: launches independent of B, ground truth per
    sequence, the library's batched run equal to the command line's files
    and, sequence by sequence, to single-sequence runs on the card, and
    sequence 0 to the CPU; then ``--shard`` on the one card."""
    from velo_tpu_torch import cli
    from velo_tpu_torch.io import kitti
    from velo_tpu_torch.pipeline import batch, odometry

    out, inputs = {}, {}
    for mode, flags in BATCH_MODES.items():
        argv = BATCH_ARGV + flags
        res, _, launches = _cli(
            argv + ["--out", os.path.join(tmp, "b-" + mode)])
        # Kernel launches per step do not depend on B: one batched launch
        # per call site (a loop over sequences would launch B times).
        _expect_launches(f"batch {mode}", launches, 4,
                         2 if mode == "fused" else 0,
                         LM_FUSED if mode == "fused" else LM_LIDAR)
        if (res["batch"], res["frames"], res["sharded"], res["prebin"],
                len(res["sequences"])) != (BATCH, BATCH_FRAMES, False, True,
                                           BATCH):
            raise AssertionError(f"batch {mode}: result line {res}")
        bi = cli.batch_inputs(cli.build_parser().parse_args(argv), dev)
        inputs[mode] = bi
        files = [kitti.read_poses(os.path.join(tmp, "b-" + mode,
                                               f"seq{b:02d}.txt"))
                 for b in range(BATCH)]
        gt_err = []
        for b in range(BATCH):
            gt = np.linalg.inv(bi.gts[b][0]) @ bi.gts[b]
            gt_t, gt_r = _pose_errors(files[b], gt)
            gt_err.append((float(gt_t.max()), float(gt_r.max())))
            if gt_t.max() > GATE_GT_M or gt_r.max() > GATE_GT_DEG[mode]:
                raise AssertionError(f"batch {mode} sequence {b}: pose error "
                                     f"vs ground truth {gt_err[-1]}")
        print(f"batch {mode}: {BATCH} x {BATCH_FRAMES} frames at {RINGS} x "
              f"{AZ}, launches {launches}, {res['agg_fps']} frames/s in all "
              f"on {smi}; worst pose error vs ground truth per sequence "
              f"{gt_err}", flush=True)

        # The library on the same inputs: the command line's pose files.
        poses, diag = batch.run_sequences(bi.scans, bi.masks, bi.cfg,
                                          images=bi.images, cam=bi.cam,
                                          device=dev)
        for b in range(BATCH):
            path = os.path.join(tmp, f"lib-{mode}-{b}.txt")
            kitti.write_poses(path, odometry.velo_to_cam_trajectory(
                poses[b], bi.tcvs[b]))
            with open(path, "rb") as x, open(os.path.join(
                    tmp, "b-" + mode, f"seq{b:02d}.txt"), "rb") as y:
                if x.read() != y.read():
                    raise AssertionError(f"batch {mode}: the library's "
                                         f"sequence {b} is not the command "
                                         "line's pose file")
        single = []
        for b in range(BATCH):
            p1, d1, _ = odometry.run_sequence(_sequence_frames(bi, b),
                                              bi.cfg, cam=bi.cam, device=dev)
            single.append(_hold_equal(
                f"batch {mode} sequence {b} vs its single-sequence run on "
                "the card", poses[b], p1,
                {k: v[b] for k, v in diag.items()}, d1))
        if not all(r["bitwise"] for r in single):
            raise AssertionError(f"batch {mode}: a sequence is not byte-equal "
                                 "to its single run")
        t0 = time.perf_counter()
        pc, dc, _ = odometry.run_sequence(_sequence_frames(bi, 0), bi.cfg,
                                          cam=bi.cam, device="cpu")
        cpu = _hold_equal(f"batch {mode} sequence 0 vs the port's CPU run "
                          f"({time.perf_counter() - t0:.1f} s)", poses[0],
                          pc, {k: v[0] for k, v in diag.items()}, dc)
        out[mode] = {"launches": launches, "cli_agg_fps":
                     res["agg_fps"], "gt_err": gt_err, "single": single,
                     "cpu_seq0": cpu}

    # --shard on one card: the batch is one chunk, the unsharded result.
    argv = BATCH_ARGV + BATCH_MODES["lidar"] + ["--shard"]
    res, _, launches = _cli(argv + ["--out", os.path.join(tmp, "b-shard")])
    _expect_launches("batch --shard", launches, 4, 0, LM_LIDAR)
    for b in range(BATCH):
        with open(os.path.join(tmp, "b-shard", f"seq{b:02d}.txt"), "rb") as x, \
                open(os.path.join(tmp, "b-lidar", f"seq{b:02d}.txt"),
                     "rb") as y:
            if x.read() != y.read():
                raise AssertionError(f"--shard: sequence {b} differs from "
                                     "the unsharded run")
    if not res["sharded"]:
        raise AssertionError(f"--shard: result line {res}")
    print(f"batch --shard on {torch.cuda.device_count()} card: every pose "
          "file byte-equal to the unsharded run", flush=True)
    out["shard"] = {"launches": launches, "equal_to_unsharded": True}
    return out, inputs


def batch_variants(dev, tmp, smi) -> dict:
    """Each solver variant through the command line's ``--batch 2`` with
    functorch's per-sample fallback off (an operation without a batching
    rule raises instead of looping over the sequences): launches per
    frame whatever B, ground truth per sequence, and each sequence's pose
    file byte-equal to its single-sequence card run's (else within 5 cm /
    0.1 deg)."""
    from velo_tpu_torch import cli
    from velo_tpu_torch.io import kitti
    from velo_tpu_torch.pipeline import odometry

    out = {}
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        for mode, flags in BATCH_VARIANTS.items():
            argv = ["--synthetic", "--batch", "2", "--frames",
                    str(BATCH_FRAMES), "--rings", str(RINGS), "--azimuth",
                    str(AZ)] + flags
            d = os.path.join(tmp, "bv-" + mode)
            res, _, launches = _cli(argv + ["--out", d])
            _expect_launches(f"batch {mode}", launches,
                             *VARIANTS[mode][2:])
            bi = cli.batch_inputs(cli.build_parser().parse_args(argv), dev)
            rows = []
            for b in range(2):
                batched = kitti.read_poses(os.path.join(d, f"seq{b:02d}.txt"))
                gt = np.linalg.inv(bi.gts[b][0]) @ bi.gts[b]
                gt_t, gt_r = _pose_errors(batched, gt)
                if (gt_t.max() > _gate_m(mode)
                        or gt_r.max() > GATE_GT_DEG[mode]):
                    raise AssertionError(
                        f"batch {mode} sequence {b}: pose error vs ground "
                        f"truth {gt_t.max():.4f} m, {gt_r.max():.4f} deg")
                p1, _, _ = odometry.run_sequence(_sequence_frames(bi, b),
                                                 bi.cfg, cam=bi.cam,
                                                 device=dev)
                single = os.path.join(tmp, f"bv-{mode}-single{b}.txt")
                kitti.write_poses(single, odometry.velo_to_cam_trajectory(
                    p1, bi.tcvs[b]))
                with open(single, "rb") as x, open(os.path.join(
                        d, f"seq{b:02d}.txt"), "rb") as y:
                    same = x.read() == y.read()
                dt, dr = _pose_errors(batched, kitti.read_poses(single))
                if not same and (dt.max() > GATE_CPU_M
                                 or dr.max() > GATE_CPU_DEG):
                    raise AssertionError(f"batch {mode} sequence {b}: "
                                         "beyond 5 cm / 0.1 deg of its "
                                         "single run")
                rows.append({"gt_err_m": float(gt_t.max()),
                             "gt_err_deg": float(gt_r.max()),
                             "single_bytes_equal": same,
                             "single_diff_m": float(dt.max()),
                             "single_diff_deg": float(dr.max())})
            print(f"batch {mode}: 2 x {BATCH_FRAMES} frames at {RINGS} x {AZ}"
                  f" (vmap fallback off), launches {launches}, "
                  f"{res['agg_fps']} frames/s in all on {smi}; per sequence "
                  f"{rows}", flush=True)
            out[mode] = {"launches": launches, "cli_agg_fps": res["agg_fps"],
                         "sequences": rows}
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)
    return out


def batch_dist_topk(dev) -> list:
    """``dist_topk`` under vmap at the path shapes, B = 4 and 8: one launch
    per batched call, each sequence bitwise equal to its unbatched launch
    and to the plain version, also with targets shared at batch stride 0;
    wrapper, kernel alone, plain, library and bound per batched call."""
    from velo_tpu_torch.kernels import dist_topk as dtk
    from velo_tpu_torch.kernels._timing import graph_ms, median_ms

    rng = np.random.default_rng(SEED + 1)
    rows = []
    for b in (4, 8):
        for q, n, bf in PATH_SHAPES:
            probs = [_dist_topk_problem(rng, q, n) for _ in range(b)]
            T, M, Q = (torch.as_tensor(np.stack(x), device=dev)
                       for x in zip(*probs))

            def vmapped(targets_shared=False):
                if targets_shared:
                    return torch.func.vmap(lambda qq: dtk.dist_topk(
                        T[0], M[0], qq, K, bf))(Q)
                return torch.func.vmap(lambda t, m, qq: dtk.dist_topk(
                    t, m, qq, K, bf))(T, M, Q)

            for shared in (False, True):
                _zero_launches()
                d2, idx = vmapped(shared)
                if _launches()["dist_topk"] != 1:
                    raise AssertionError("a vmapped dist_topk call is not "
                                         "one launch")
                for s in range(b):
                    j = 0 if shared else s
                    one = dtk.dist_topk(T[j], M[j], Q[s], K, bf)
                    ref = dtk.dist_topk_reference(T[j], M[j], Q[s], K, bf)
                    if not all(torch.equal(x, y) for x, y in zip(
                            (d2[s], idx[s], d2[s], idx[s]), one + ref)):
                        raise AssertionError(
                            f"batched dist_topk B={b} {(q, n, bf)} sequence "
                            f"{s} (shared targets: {shared}) != unbatched "
                            "or plain")
            ms = median_ms(vmapped)
            kernel_ms = graph_ms(lambda: dtk._launch(T, M, Q, K, bf))
            plain_ms = median_ms(lambda: torch.func.vmap(
                lambda t, m, qq: dtk.dist_topk_reference(t, m, qq, K, bf))(
                    T, M, Q), bursts=5, calls=2)
            library_ms = median_ms(lambda: torch.topk(
                torch.cdist(Q, T), K, dim=2, largest=False))
            bound_ms, bound_by = _bound(
                *(b * x for x in dist_topk_roof.call_work(q, n, K)))
            g = dtk.launch_geometry(q, n, bf, K, b)
            rows.append({"path": "batch", "batch": b, "q": q, "n": n,
                         "bin_factor": bf, "query_tile": g.tq,
                         "blocks": g.blocks * b, "ms": ms,
                         "kernel_only_ms": kernel_ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by})
            print(f"dist_topk batch B={b} Q={q} N={n} B_fold={bf} (query "
                  f"tile {g.tq}, {g.blocks} x {b} blocks): one launch, "
                  f"bitwise equal to unbatched and plain (batched and "
                  f"shared targets); wrapper {ms:.4f} ms, kernel alone "
                  f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"topk(cdist) {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
                  f"({bound_by})", flush=True)
            del T, M, Q
    torch.cuda.empty_cache()
    return rows


def batch_klt_l0(dev, bi) -> list:
    """``klt_l0`` under vmap on the batch mode's images (128 x 384, 128
    corners of each sequence's frame 0 tracked into frame 1, 8 iterations,
    and back, 4), B = 4 and 8 (the four sequences twice): one launch, each
    sequence bitwise equal to its unbatched launch and to the plain
    version, also with images shared at batch stride 0."""
    from velo_tpu_torch.kernels import klt_l0 as kl
    from velo_tpu_torch.kernels._timing import graph_ms, median_ms
    from velo_tpu_torch.vision import corners

    vc = bi.cfg.vision
    im = torch.as_tensor(bi.images[:, :2], device=dev)  # (4, 2, H, W)
    uv0 = torch.stack([corners.detect(im[s, 0], vc).uv for s in
                       range(BATCH)]).contiguous()
    rows = []
    for b in (4, 8):
        sel = [s % BATCH for s in range(b)]
        I0, I1, U0 = im[sel, 0], im[sel, 1], uv0[sel]
        fwd = torch.func.vmap(lambda a, c, u: kl.track_level0_reference(
            a, c, u, u, vc, vc.klt_iters)[0])(I0, I1, U0)
        for name, (A, C, UP, UC, iters) in {
                "forward": (I0, I1, U0, U0, vc.klt_iters),
                "backward": (I1, I0, fwd, U0, vc.klt_iters_fb)}.items():
            def vmapped(shared=False):
                if shared:
                    return torch.func.vmap(lambda up, uc: kl.track_level0(
                        A[0], C[0], up, uc, vc, iters))(UP, UC)
                return torch.func.vmap(lambda *x: kl.track_level0(
                    *x, vc, iters))(A, C, UP, UC)

            for shared in (False, True):
                _zero_launches()
                uv, ok = vmapped(shared)
                if _launches()["klt_l0"] != 1:
                    raise AssertionError("a vmapped klt_l0 call is not one "
                                         "launch")
                for s in range(b):
                    j = 0 if shared else s
                    args = (A[j], C[j], UP[s], UC[s], vc, iters)
                    one, ref = kl.track_level0(*args), \
                        kl.track_level0_reference(*args)
                    if not all(torch.equal(x, y) for x, y in zip(
                            (uv[s], ok[s], uv[s], ok[s]), one + ref)):
                        raise AssertionError(
                            f"batched klt_l0 {name} B={b} sequence {s} "
                            f"(shared images: {shared}) != unbatched or "
                            "plain")
            ms = median_ms(vmapped)
            kernel_ms = graph_ms(lambda: kl._launch(A, C, UP, UC, iters))
            plain_ms = median_ms(lambda: torch.func.vmap(
                lambda *x: kl.track_level0_reference(*x, vc, iters))(
                    A, C, UP, UC), bursts=5, calls=2)
            bound_ms, bound_by = _bound(*(
                b * x for x in klt_l0_roof.call_work(BATCH_K, iters, BATCH_H,
                                                     BATCH_W)))
            rows.append({"path": "batch", "batch": b, "call": name,
                         "h": BATCH_H, "w": BATCH_W, "k": BATCH_K,
                         "iters": iters, "ms": ms,
                         "kernel_only_ms": kernel_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "ok": int(ok.sum())})
            print(f"klt_l0 batch B={b} {name} {BATCH_H}x{BATCH_W} K="
                  f"{BATCH_K} iters={iters}: one launch, bitwise equal to "
                  f"unbatched and plain (batched and shared images); "
                  f"wrapper {ms:.4f} ms, kernel alone {kernel_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
                  f"({bound_by}); {int(ok.sum())} ok", flush=True)
    return rows


def _profile_steps(step, carry, frames) -> dict:
    """:func:`_profile_calls` over ``step`` through ``frames`` from
    ``carry``."""
    def run():
        c = carry
        for fr in frames:
            c, _ = step(c, *fr)

    return {"frames": len(frames), **_profile_calls(run)}


def batch_throughput(dev, bi, smi) -> dict:
    """Aggregate frames/s of ``run_sequences`` at B = 1, 2, 4, 8 on the
    fused inputs (8: the four sequences twice), warm; then, stepping by
    hand through ``batched_step`` at B = 1 and 8 and through the plain
    ``odometry.step`` (one sequence), the host's time per step call, and
    for the batched steps a profile of the last frame: busy share and card
    kernels; the batched steps eager and replayed from the CUDA graphs
    that ``run_sequences`` captured."""
    from velo_tpu_torch.pipeline import batch, graphs, odometry

    cfg = bi.cfg

    def put(x, sel):
        return torch.as_tensor(np.ascontiguousarray(x[sel])).to(dev)

    def measure(name, step, carry, frames, profiled=True):
        """Host time of each step call; then a profile of the last step
        again, from the carry entering it (the profiler's own costs stay
        out of the host times)."""
        host, carries, _, _ = _step_through(step, carry, frames)
        prof = (_profile_steps(step, carries[-1], frames[-1:]) if profiled
                else None)
        print(f"{name}: host {[round(1e3 * h, 1) for h in host]} ms per "
              f"step call (frames 0-{len(frames) - 1}); profile of the last "
              f"frame: {prof}", flush=True)
        return {"host_ms_per_step": [1e3 * h for h in host],
                "profile": prof}

    def batch_frames(sel):
        return [(put(bi.scans[:, f], sel), put(bi.masks[:, f], sel))
                + ((put(bi.images[:, f], sel),) if cfg.use_vision else ())
                for f in range(BATCH_FRAMES)]

    rows = {}
    for b in BATCH_SIZES:
        sel = [s % BATCH for s in range(b)]
        walls = []
        graphs.release()
        for _ in range(2):  # the first run captures the graphs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch.run_sequences(bi.scans[sel], bi.masks[sel], cfg,
                                images=bi.images[sel], cam=bi.cam,
                                device=dev)
            walls.append(time.perf_counter() - t0)
        wall = walls[1]
        rows[b] = {"batch": b, "agg_fps": b * BATCH_FRAMES / wall,
                   "wall_ms_per_step": 1e3 * wall / BATCH_FRAMES,
                   "first_run_s": walls[0], "captures": [
                       c._asdict() for c in graphs.captures()]}
        print(f"batch throughput B={b}: {rows[b]['agg_fps']:.3f} frames/s "
              f"in all, {rows[b]['wall_ms_per_step']:.1f} ms per batched "
              f"step (warm; the run that captured took {walls[0]:.1f} s), "
              f"on {smi}", flush=True)
        if b in (1, 8):
            # Stepped by hand through the graphs run_sequences captured.
            rows[b]["captured"] = measure(
                f"batch B={b} captured", batch.jit_batched_step(cfg, bi.cam),
                batch.broadcast_carry(odometry.init_carry(cfg, dev), b),
                batch_frames(sel))
        graphs.release()

    for b in (1, 8):
        sel = [s % BATCH for s in range(b)]
        rows[b].update(measure(
            f"batch B={b} stepped", batch.batched_step(cfg, bi.cam),
            batch.broadcast_carry(odometry.init_carry(cfg, dev), b),
            batch_frames(sel)))
    frames = [tuple(torch.as_tensor(np.ascontiguousarray(x)).to(dev)
                    for x in fr) for fr in _sequence_frames(bi, 0)]

    def plain_step(carry, scan, mask, image=None):
        return odometry.step(carry, scan, mask, cfg, image=image, cam=bi.cam)

    rows["unvmapped"] = {"batch": 1, **measure(
        "unvmapped step, one sequence", plain_step,
        odometry.init_carry(cfg, dev), frames, profiled=False)}
    return rows


# The long drive: the reference's drift runs take 150 frames; 40 take both
# map rings past their first wrap at this width (a frame inserts up to
# 3072 edges and 6144 planars into rings of 16384 and 32768) inside the
# script's time limit.
LONG_FRAMES = 40
# The warm pass runs as two run_scan calls, split at an odd frame: the map
# is maintained every 2 frames, so the second call starts off the cadence.
LONG_SPLIT = 21
# Median per-frame relative error, about twice the reference's 0.016-0.019
# m over its own 150-frame drives, and the ATE bound (m).
GATE_LONG_MED_REL_M, GATE_LONG_ATE_M = 0.04, 1.0


def long_drive_kw(cache_dir) -> dict:
    return dict(frames=LONG_FRAMES, rings=RINGS, az=AZ, seed=SEED,
                cache_dir=cache_dir)


def _named_leaves(carry) -> dict:
    """A LiDAR-only carry's tensors by name."""
    out = {k: v for k, v in carry._asdict().items()
           if isinstance(v, torch.Tensor)}
    for name in ("edge_map", "planar_map"):
        out.update({f"{name}.{k}": v for k, v in
                    getattr(carry, name)._asdict().items()})
    return out


def long_drive(dev, drive, smi) -> dict:
    """The long drive through ``velo_tpu_torch.evaluation.longrun`` (see
    the module docstring, phase 11c): the main path past the first wrap
    of both map rings."""
    from velo_tpu_torch.evaluation import longrun
    from velo_tpu_torch.pipeline import graphs, odometry

    scans, masks, gt_velo, gt_cam, T_cv, _, _ = drive
    digest = longrun.fixture_digest(scans, masks)
    cfg = longrun.run_config("base", RINGS, AZ, prebin=True)
    grids, valid = longrun.prebin(scans, masks, cfg.lidar)
    scans_d = torch.as_tensor(grids).to(dev)
    masks_d = torch.as_tensor(valid).to(dev)

    # The harness's own cold run (captures included).
    _zero_launches()
    _, out, secs = longrun.run_drive(cfg, scans_d, masks_d)
    launches = _launches()
    _expect_launches("long-drive", launches, 4, 0, LM_LIDAR)
    captures = [c._asdict() for c in graphs.captures()]
    poses = out.T_w.cpu().numpy()
    if not np.all(np.isfinite(poses)) or poses.shape != (LONG_FRAMES, 4, 4):
        raise AssertionError(f"long-drive: bad poses: shape {poses.shape}")
    row, rel, _ = longrun.metrics_row("base", SEED, poses, gt_velo, gt_cam,
                                      T_cv, out.degenerate.cpu().numpy(),
                                      secs)

    # Warm, as two run_scan calls: the cadence carries across them.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, first = odometry.run_scan(odometry.init_carry(cfg, dev),
                                     scans_d[:LONG_SPLIT],
                                     masks_d[:LONG_SPLIT], cfg)
    _, second = odometry.run_scan(carry, scans_d[LONG_SPLIT:],
                                  masks_d[LONG_SPLIT:], cfg)
    torch.cuda.synchronize()
    warm_fps = LONG_FRAMES / (time.perf_counter() - t0)
    differ = [k for k in out._fields if not torch.equal(
        torch.cat([getattr(first, k), getattr(second, k)]), getattr(out, k))]
    if differ:
        raise AssertionError(f"long-drive: two run_scan calls differ from "
                             f"one in {differ}")

    # Frame by frame, keeping the carry entering each frame: how full the
    # rings are, and the card's carry for the CPU.
    carries, fill, step_poses = [], [], []
    carry = odometry.init_carry(cfg, dev)
    for f in range(LONG_FRAMES):
        carries.append(graphs.clone(carry))
        carry, o = odometry.jit_step(carry, scans_d[f], masks_d[f], cfg)
        fill.append(torch.stack([
            carry.prev_edge_mask.sum(), carry.prev_planar_mask.sum(),
            carry.edge_map.cursor.long(), carry.planar_map.cursor.long(),
            carry.edge_map.mask.sum(), carry.planar_map.mask.sum()]))
        step_poses.append(o.T_w)
    carries.append(graphs.clone(carry))
    fill = torch.stack(fill).cpu().numpy()
    if not torch.equal(torch.stack(step_poses), out.T_w):
        raise AssertionError("long-drive: jit_step frame by frame differs "
                             "from run_scan")
    rings = {}
    for j, (name, cap) in enumerate((("edge", cfg.map.edge_capacity),
                                     ("planar", cfg.map.planar_capacity))):
        cum = np.cumsum(fill[:, j])
        if not np.array_equal(fill[:, 2 + j], cum % cap):
            raise AssertionError(f"long-drive: {name} write head "
                                 f"{fill[:, 2 + j].tolist()} is not the "
                                 f"points inserted mod {cap}")
        over = np.flatnonzero(cum > cap)
        rings[name] = {"capacity": cap, "inserted_per_frame":
                       fill[:, j].tolist(), "cumulative": cum.tolist(),
                       "valid_after_frame": fill[:, 4 + j].tolist(),
                       "first_wrap_frame": int(over[0]) if len(over)
                       else None}
        print(f"long-drive: {name} ring of {cap}: cumulative points "
              f"inserted per frame {cum.tolist()}; first wrapped in frame "
              f"{rings[name]['first_wrap_frame']}; valid after the last "
              f"frame {int(fill[-1, 4 + j])}", flush=True)
    if any(r["first_wrap_frame"] is None for r in rings.values()):
        raise AssertionError("long-drive: a map ring never wrapped")
    wrap = max(r["first_wrap_frame"] for r in rings.values())

    # The card against the CPU, one step each, after the wrap.
    cpu = {}
    for f in sorted({wrap + 1, LONG_FRAMES - 1}):
        t0 = time.perf_counter()
        cpu_carry = odometry.carry_from_jax_numpy(
            odometry.carry_to_numpy(carries[f]), "cpu")
        new, o = odometry.step(cpu_carry, torch.as_tensor(grids[f]),
                               torch.as_tensor(valid[f]), cfg)
        dt, dr = _pose_errors(poses[f][None], o.T_w.numpy()[None])
        card = _named_leaves(carries[f + 1])
        differ = [k for k, v in _named_leaves(new).items()
                  if not torch.equal(card[k].cpu(), v)]
        cpu[f] = {"diff_m": float(dt[0]), "diff_deg": float(dr[0]),
                  "bitwise": np.array_equal(poses[f], o.T_w.numpy())
                  and not differ, "leaves_differ": differ}
        print(f"long-drive frame {f}: one CPU step from the card's carry: "
              f"pose {dt[0]:.6f} m, {dr[0]:.6f} deg, bitwise "
              f"{cpu[f]['bitwise']}, carry leaves differing {differ} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if dt[0] > GATE_CPU_M or dr[0] > GATE_CPU_DEG:
            raise AssertionError(f"long-drive frame {f}: card and CPU "
                                 "disagree")

    # Launches inside replays at full rings.
    prof = _profile_calls(lambda: odometry.run_scan(
        carries[wrap + 1], scans_d[wrap + 1:wrap + 3],
        masks_d[wrap + 1:wrap + 3], cfg))
    replayed = {k: v / 2 for k, v in prof["launches"].items()}
    if replayed != _per_frame(4, 0, LM_LIDAR):
        raise AssertionError(f"long-drive: launches per replayed frame "
                             f"{replayed}")
    graphs.release()

    print(f"long-drive: {LONG_FRAMES} frames of seed {SEED} at {RINGS} x "
          f"{AZ} (fixture sha256 {digest[:16]}): row {json.dumps(row)}; "
          f"wrapper calls {launches} ({len(captures)} graphs), launches per "
          f"replayed frame after the wrap {replayed}, card "
          f"{prof['device_s'] / 2:.4f} s per frame there; cold "
          f"{row['secs']} s incl. captures, warm {warm_fps:.3f} frames/s "
          f"(two run_scan calls, bitwise equal to one) on {smi}",
          flush=True)
    if (row["med_rel_err_m"] > GATE_LONG_MED_REL_M
            or row["ate_m"] > GATE_LONG_ATE_M):
        raise AssertionError(
            f"long-drive: median relative error {row['med_rel_err_m']} m "
            f"(gate {GATE_LONG_MED_REL_M}) or ATE {row['ate_m']} m (gate "
            f"{GATE_LONG_ATE_M})")
    return {"frames": LONG_FRAMES, "seed": SEED, "fixture_sha256": digest,
            "row": row, "launches": launches, "captures": captures,
            "launches_per_replayed_frame": replayed,
            "profile_2_frames_after_wrap": prof, "warm_fps": warm_fps,
            "rings": rings, "cpu_after_wrap": cpu,
            "rel_err_m": [round(float(x), 5) for x in rel]}


@contextlib.contextmanager
def _time_calls(spent, *targets):
    """Add each call's seconds to ``spent[name]`` for every ``(module,
    name)`` in ``targets`` while the block runs (nested calls counted in
    both)."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def timed(fn, name):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return wrapper

    for mod, name, fn in saved:
        setattr(mod, name, timed(fn, name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _seconds_split(spent, total) -> dict:
    """Host set-up, device raycast, host tail and pad + cache write of
    one accelerated simulation, from :func:`_time_calls`' ``spent``."""
    raycast = spent.get("_sweep_hits", 0.0) + spent.get("_render_frames", 0.0)
    outer = (spent.get("simulate_sweep_batch", 0.0)
             + spent.get("render_batch", 0.0))
    return {"host_setup_s": outer - raycast, "device_raycast_s": raycast,
            "host_tail_s": spent["make_fixture"] - outer,
            "pad_and_write_s": total - spent["make_fixture"],
            "total_s": total}


def _scans_close(what, ref, acc) -> dict:
    """The reference's bounds for its accelerated against its numpy scans
    (``tests/unit/test_fixtures_accel.py``): lengths within max(2, 0.1 %),
    99th percentile of point distance over the common prefix < 1 mm."""
    worst_len, worst_p99 = 0, 0.0
    for f, (a, b) in enumerate(zip(ref, acc)):
        n = min(len(a), len(b))
        d = np.linalg.norm(a[:n, :3] - b[:n, :3], axis=1)
        p99 = float(np.percentile(d, 99))
        if abs(len(a) - len(b)) > max(2, 0.001 * n) or p99 >= 1e-3:
            raise AssertionError(f"fixtures-accel {what} frame {f}: "
                                 f"{len(a)} numpy against {len(b)} "
                                 f"accelerated points, 99th percentile "
                                 f"distance {p99} m")
        worst_len = max(worst_len, abs(len(a) - len(b)))
        worst_p99 = max(worst_p99, p99)
    return {"max_len_diff": worst_len, "max_p99_dist_m": worst_p99}


# The drive simulator raycasts on the device inside this block
# (``velo_tpu_torch.io.fixtures_accel``).
ACCEL_SWITCH = mock.patch.dict(os.environ, {"VELO_FIX_ACCEL": "1"})


def fixtures_accel_phase(dev, drive, smi) -> dict:
    """The drive simulator on the card (``VELO_FIX_ACCEL=1``, see the
    module docstring, phase 11d): the long drive and the fused fixture
    against their numpy drives, card against CPU, and odometry on the
    accelerated drive."""
    from velo_tpu_torch.evaluation import longrun
    from velo_tpu_torch.io import fixtures, fixtures_accel

    targets = [(fixtures, "make_fixture")] + [
        (fixtures_accel, name) for name in (
            "simulate_sweep_batch", "_sweep_hits", "render_batch",
            "_render_frames")]
    cache_dir = tempfile.mkdtemp(prefix="velo-fixtures-accel-")
    try:
        # (a) The long drive, simulated on the card into its own cache.
        kw = dict(long_drive_kw(cache_dir), device=dev)
        spent = {}
        with ACCEL_SWITCH, _time_calls(spent, *targets):
            t0 = time.perf_counter()
            scans, masks, gt_velo, gt_cam, T_cv, _, _ = longrun.get_fixture(
                **kw)
            drive_split = _seconds_split(spent, time.perf_counter() - t0)
            path = longrun.fixture_path(**kw)
            generator = longrun.generator(dev)
        if not (path.endswith(f"_accel-torch-{dev.type}.npz")
                and os.path.exists(path)):
            raise AssertionError(f"fixtures-accel: cache file {path}")
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    np_scans, np_masks, np_gt_velo = drive[0], drive[1], drive[2]
    if not np.array_equal(gt_velo, np_gt_velo):
        raise AssertionError("fixtures-accel: ground truth differs")
    drive_close = _scans_close("long drive", [s[m] for s, m in zip(
        np_scans, np_masks)], [s[m] for s, m in zip(scans, masks)])
    digest = longrun.fixture_digest(scans, masks)
    world = fixtures.default_world(SEED)
    poses = fixtures.make_trajectory(LONG_FRAMES + 1, speed=8.0,
                                     seed=SEED + 2)
    t0 = time.perf_counter()
    fixtures.simulate_velodyne(world, poses[0], poses[1], n_rings=RINGS,
                               n_azimuth=AZ)
    numpy_frame_s = time.perf_counter() - t0

    # (b) The fused cell's 4 frames with images, against the memo's numpy
    # fixture (make_frames).
    spent = {}
    with ACCEL_SWITCH, _time_calls(spent, *targets):
        t0 = time.perf_counter()
        fx = fixtures.make_fixture(**FRAMES_KW, device=dev)
        frames_split = _seconds_split(spent, time.perf_counter() - t0)
    ref = _FIXTURES[_fixture_key(FRAMES_KW)]
    frames_close = _scans_close("fused fixture", ref.scans, fx.scans)
    d = np.abs(ref.images - fx.images)
    images = {"p999_abs_diff": float(np.percentile(d, 99.9)),
              "mean_abs_diff": float(d.mean()), "max_abs_diff": float(
                  d.max())}
    if images["p999_abs_diff"] >= 1e-2 or images["mean_abs_diff"] >= 1e-4:
        raise AssertionError(f"fixtures-accel images: {images}")
    P, T_cv4 = fixtures.default_calib(IMG_H, IMG_W)
    frame_poses = fixtures.make_trajectory(N_FRAMES + 1, speed=8.0,
                                           seed=SEED + 2)
    T_w_cams = [frame_poses[i] @ np.linalg.inv(T_cv4) for i in range(2)]
    t0 = time.perf_counter()
    fixtures.render_camera(world, T_w_cams[0], P, IMG_H, IMG_W)
    numpy_image_s = time.perf_counter() - t0

    # (c) The card against the port's CPU on frames 0-1 of both.
    sweep, warm = {}, {}
    for where in (dev, "cpu"):
        with _time_calls(warm, (fixtures_accel, "_sweep_hits")):
            sweep[str(where)] = fixtures_accel.simulate_sweep_batch(
                world, poses[:3], RINGS, AZ, 2.0, -24.8, 80.0, device=where)
        if where is dev:  # the card warm: copies in and out included
            warm_raycast_s = warm.pop("_sweep_hits") / 2
    t_card, dirs_s = sweep[str(dev)]
    t_cpu = sweep["cpu"][0]
    t_bitwise = np.array_equal(t_card, t_cpu)
    for i in range(2):  # the drive of (a) is these hit distances
        if not np.array_equal(fixtures_accel.finish_scan(
                t_card[i], dirs_s, None, 0.0), scans[i][masks[i]]):
            raise AssertionError(f"fixtures-accel: frame {i} of the drive "
                                 "is not its raycast")
    scans_bitwise = all(np.array_equal(
        fixtures_accel.finish_scan(t_card[i], dirs_s, None, 0.0),
        fixtures_accel.finish_scan(t_cpu[i], dirs_s, None, 0.0))
        for i in range(2))
    img_card = fixtures_accel.render_batch(world, T_w_cams, P, IMG_H, IMG_W,
                                           device=dev)
    img_cpu = fixtures_accel.render_batch(world, T_w_cams, P, IMG_H, IMG_W,
                                          device="cpu")
    di = np.abs(img_card - img_cpu)
    card_cpu = {"t_bitwise": t_bitwise, "t_max_abs_diff": float(np.max(
        np.abs(np.where(np.isfinite(t_card), t_card, 0.0)
               - np.where(np.isfinite(t_cpu), t_cpu, 0.0)))),
        "t_inf_equal": bool(np.array_equal(np.isinf(t_card),
                                           np.isinf(t_cpu))),
        "scans_bitwise": scans_bitwise,
        "images_max_abs_diff": float(di.max()),
        "images_pixels_differ": int((di > 0).sum()),
        "images_pixels": int(di.size),
        "warm_card_raycast_s_per_frame": warm_raycast_s,
        "cpu_raycast_s_per_frame": warm["_sweep_hits"] / 2}
    print(f"fixtures-accel: card against CPU on frames 0-1: {card_cpu}",
          flush=True)
    if not card_cpu["t_inf_equal"] or card_cpu["t_max_abs_diff"] > 1e-3:
        raise AssertionError(f"fixtures-accel: card and CPU disagree: "
                             f"{card_cpu}")

    # (d) Odometry on the accelerated drive, held to long-drive's gates.
    cfg = longrun.run_config("base", RINGS, AZ, prebin=True)
    grids, valid = longrun.prebin(scans, masks, cfg.lidar)
    scans_d = torch.as_tensor(grids).to(dev)
    masks_d = torch.as_tensor(valid).to(dev)
    _zero_launches()
    _, out, secs = longrun.run_drive(cfg, scans_d, masks_d)
    launches = _launches()
    _expect_launches("fixtures-accel", launches, 4, 0, LM_LIDAR)
    est = out.T_w.cpu().numpy()
    if not np.all(np.isfinite(est)) or est.shape != (LONG_FRAMES, 4, 4):
        raise AssertionError(f"fixtures-accel: bad poses: shape {est.shape}")
    row, _, _ = longrun.metrics_row("base", SEED, est, gt_velo, gt_cam, T_cv,
                                    out.degenerate.cpu().numpy(), secs)
    print(f"fixtures-accel: {LONG_FRAMES} frames of seed {SEED} at {RINGS} "
          f"x {AZ} raycast on the card (fixture sha256 {digest[:16]}, "
          f"generator {generator}): seconds "
          f"{json.dumps(drive_split)}; the numpy generator "
          f"{numpy_frame_s:.2f} s per frame on the host; against the numpy "
          f"drive {drive_close}; the fused fixture ({N_FRAMES} frames, "
          f"{IMG_H} x {IMG_W}): seconds {json.dumps(frames_split)}, scans "
          f"{frames_close}, images {images}, numpy {numpy_image_s:.2f} s "
          f"per image; odometry row {json.dumps(row)}, wrapper calls "
          f"{launches} on {smi}", flush=True)
    if (row["med_rel_err_m"] > GATE_LONG_MED_REL_M
            or row["ate_m"] > GATE_LONG_ATE_M):
        raise AssertionError(
            f"fixtures-accel: median relative error {row['med_rel_err_m']} "
            f"m (gate {GATE_LONG_MED_REL_M}) or ATE {row['ate_m']} m (gate "
            f"{GATE_LONG_ATE_M})")
    return {"frames": LONG_FRAMES, "seed": SEED, "fixture_sha256": digest,
            "generator": generator, "drive_seconds": drive_split,
            "numpy_seconds_per_frame": numpy_frame_s,
            "drive_vs_numpy": drive_close, "fused_fixture_seconds":
            frames_split, "fused_scans_vs_numpy": frames_close,
            "images_vs_numpy": images,
            "numpy_seconds_per_image": numpy_image_s,
            "card_vs_cpu_frames_0_1": card_cpu, "row": row,
            "launches": launches}


DIST_WORKER = r"""
import datetime, pickle, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist

dist.init_process_group("gloo", init_method={init!r}, world_size=2,
                        rank={rank}, timeout=datetime.timedelta(seconds=600))
from velo_tpu_torch.pipeline import distributed

with open({cfg_path!r}, "rb") as f:
    cfg = pickle.load(f)
data = np.load({inputs!r})
mine = slice({rank} * {b_local}, ({rank} + 1) * {b_local})
poses, diag, gcost = distributed.run_sequences_multihost(
    data["scans"][mine], data["masks"][mine], cfg, with_global_cost=True,
    device="cuda:0")
np.savez({out!r}, poses=poses, gcost=gcost, cost=diag["cost"])
dist.destroy_process_group()
print("WORKER_OK", {rank}, flush=True)
"""
DIST_FRAMES, DIST_LOCAL = 3, 2


def distributed_phase(dev, bi, tmp, smi) -> dict:
    """``pipeline.distributed.run_sequences_multihost`` in two processes
    (gloo over loopback, both on card 0), 2 LiDAR sequences of 3 frames
    each at 64 x 2048 (the batch phase's drives, seeds 100-103): each
    rank's poses byte-equal to a single-process ``batch.run_sequences``
    of its sequences, and the global cost the mean over all 4."""
    import pickle
    import socket

    from velo_tpu_torch.pipeline import batch, graphs

    scans = bi.scans[:2 * DIST_LOCAL, :DIST_FRAMES]
    masks = bi.masks[:2 * DIST_LOCAL, :DIST_FRAMES]
    inputs = os.path.join(tmp, "dist-inputs.npz")
    np.savez(inputs, scans=scans, masks=masks)
    cfg_path = os.path.join(tmp, "dist-cfg.pkl")
    with open(cfg_path, "wb") as f:
        pickle.dump(bi.cfg, f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", DIST_WORKER.format(
            repo=repo, init=f"tcp://127.0.0.1:{port}", rank=rank,
            cfg_path=cfg_path, inputs=inputs, b_local=DIST_LOCAL,
            out=os.path.join(tmp, f"dist-rank{rank}.npz"))],
        env=dict(os.environ, GLOO_SOCKET_IFNAME="lo"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"WORKER_OK {rank}" not in so:
            raise AssertionError(f"distributed rank {rank} failed "
                                 f"(rc {p.returncode}):\n{so}\n{se[-4000:]}")
    costs, rows = [], []
    for rank in range(2):
        got = np.load(os.path.join(tmp, f"dist-rank{rank}.npz"))
        mine = slice(rank * DIST_LOCAL, (rank + 1) * DIST_LOCAL)
        graphs.release()
        single, sdiag = batch.run_sequences(scans[mine], masks[mine], bi.cfg,
                                            device=dev)
        if got["poses"].tobytes() != single.tobytes():
            raise AssertionError(f"distributed rank {rank}: poses differ "
                                 "from the single-process run")
        costs.append(sdiag["cost"])
        rows.append(float(got["gcost"]))
    graphs.release()
    mean = float(np.mean(np.concatenate(costs).astype(np.float64)))
    if any(abs(g - mean) > 1e-6 * abs(mean) for g in rows):
        raise AssertionError(f"distributed: global cost {rows}, mean {mean}")
    print(f"distributed: 2 processes x {DIST_LOCAL} sequences x "
          f"{DIST_FRAMES} frames at {RINGS} x {AZ} on one card, gloo: each "
          f"rank byte-equal to its single-process run; global cost "
          f"{rows} = mean {mean} ({wall:.1f} s with process start-up) on "
          f"{smi}", flush=True)
    return {"ranks": 2, "sequences_per_rank": DIST_LOCAL,
            "frames": DIST_FRAMES, "bytes_equal": True,
            "global_cost": rows, "mean_cost": mean, "wall_s": wall}


def main() -> int:
    t_start = time.perf_counter()
    smi = card_check()
    dev = torch.device("cuda", 0)
    memoize_fixtures()
    # The batch phase's drives and the long drive simulate meanwhile, on
    # other cores.
    long_dir = tempfile.mkdtemp(prefix="velo-long-drive-")
    sims = start_prefetch(batch_fixture_kws(), long_drive_kw(long_dir))
    seconds = {}

    def phase(name, fn, *args):
        from velo_tpu_torch.pipeline import graphs

        t0 = time.perf_counter()
        out = fn(*args)
        graphs.release()  # each phase captures the graphs it needs
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]:.1f} s", flush=True)
        return out

    try:
        phase("build", build)
        fx, grids = phase("fixture", make_frames)
        dk = phase("dist_topk", dist_topk_check, dev)
        kk = phase("klt_l0", klt_l0_check, dev, fx)
        lk = phase("lm_lidar", lm_lidar_check, dev, grids)
        jk = phase("lm_joint", lm_joint_check, dev, fx, grids)
        ck = phase("corr_fit", corr_fit_check, dev, grids)
        runs, cpu_poses = {}, {}
        for mode in ("fused", "fused-gather", "lidar", *VARIANTS):
            runs[mode], cpu_poses[mode] = phase(mode, pipeline_run, dev,
                                                mode, fx, grids)
        runs["run-scan"] = phase("run-scan", run_scan_phase, dev, fx, grids,
                                 cpu_poses, smi)
        for mode in ("fused", "fused-gather", "lidar", *VARIANTS):
            print(f"{mode} 64x2048 warm pass: {runs[mode]['fps']:.3f} "
                  f"frames/s on {smi}", flush=True)
        del fx, grids
        with tempfile.TemporaryDirectory() as tmp:
            root = phase("export", export_phase, tmp)
            runs["cli-kitti"] = phase("cli-kitti", cli_kitti, dev, tmp, root,
                                      smi)
            runs["cli-variants"] = phase("cli-variants", cli_variants, tmp)
            runs["png"] = phase("png", png_phase, tmp, smi)
            runs["loader"] = phase("loader", loader_phase, root)
            phase("batch fixtures", finish_prefetch, sims)
            runs["batch"], inputs = phase("batch", batch_cli, dev, tmp, smi)
            runs["batch-variants"] = phase("batch variants", batch_variants,
                                           dev, tmp, smi)
            runs["distributed"] = phase("distributed", distributed_phase,
                                        dev, inputs["lidar"], tmp, smi)
        long_numpy = sims[3].result()
        runs["long-drive"] = phase("long-drive", long_drive, dev,
                                   long_numpy, smi)
        runs["fixtures-accel"] = phase("fixtures-accel",
                                       fixtures_accel_phase, dev,
                                       long_numpy, smi)
        del long_numpy
        dk["per_shape"] += phase("batch dist_topk", batch_dist_topk, dev)
        kk["per_shape"] += phase("batch klt_l0", batch_klt_l0, dev,
                                 inputs["fused"])
        runs["batch-throughput"] = phase(
            "batch throughput", batch_throughput, dev, inputs["fused"], smi)
    finally:
        sims[0].shutdown(cancel_futures=True)
        shutil.rmtree(long_dir, ignore_errors=True)

    def entry(name, source, replaces, check, library_ms, **extra):
        # One frame's calls of the forward path; the smoother's and the
        # batch's shapes stand in "per_shape" only.
        shapes = [s for s in check["per_shape"]
                  if s.get("path", "forward") == "forward"]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # This slice's path: run_scan, fused, one graph replay per
            # frame.  The wrapper counts its calls: each captured graph's
            # warm-up and capture; the profile counts the launches inside
            # the replays.
            "launches": runs["run-scan"]["fused"]["launches"][name],
            "launches_per_replayed_frame": runs["run-scan"]["fused"][
                "launches_per_replayed_frame"][name],
            "launches_per_replayed_frame_lidar": runs["run-scan"]["lidar"][
                "launches_per_replayed_frame"][name],
            "launches_by_path": {
                **{mode: runs[mode]["launches"][name] for mode in (
                    "fused", "lidar", *VARIANTS)},
                "run-scan-lidar": runs["run-scan"]["lidar"]["launches"][name],
                "batch": runs["batch"]["fused"]["launches"][name],
                "batch-lidar": runs["batch"]["lidar"]["launches"][name],
                "batch-shard": runs["batch"]["shard"]["launches"][name],
                **{f"batch-{mode}": run["launches"][name] for mode, run in
                   runs["batch-variants"].items()},
                "long-drive": runs["long-drive"]["launches"][name],
                "fixtures-accel": runs["fixtures-accel"]["launches"][name],
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
    # lm_lidar's numbers are per solve: the mean of a map and a
    # scan-to-scan solve.
    shapes = lk["per_shape"]
    kernels.append(entry(
        "lm_lidar", "velo_tpu_torch/csrc/lm_lidar.cu",
        "solve/lm.lm_solve with the staged prior (plain PyTorch; the "
        "reference has no pallas_call here)", lk, None,
        library_call="none: no single PyTorch call runs an LM solve",
        t_bitwise=lk["t_bitwise"], solves=lk["solves"],
        **{k: sum(s[k] for s in shapes) / len(shapes)
           for k in ("ms", "plain_ms", "bound_ms")}))
    # lm_joint's numbers are per solve: the richest scan-to-scan solve.
    kernels.append(entry(
        "lm_joint", "velo_tpu_torch/csrc/lm_joint.cu",
        "solve/lm.lm_solve over the joint LiDAR-visual system with the "
        "staged prior (plain PyTorch; the reference has no pallas_call "
        "here)", jk, None,
        library_call="none: no single PyTorch call runs an LM solve",
        t_bitwise=jk["t_bitwise"], solves=jk["solves"]))
    # corr_fit's numbers are per call: the dense engine's scan-to-scan and
    # map fits (a LiDAR frame runs 6 of the one and 3 of the other).
    shapes = [s for s in ck["per_shape"] if s["engine"] == "lidar"]
    kernels.append(entry(
        "corr_fit", "velo_tpu_torch/csrc/corr_fit.cu",
        "none: the fits of solve/icp (plain PyTorch; the reference's are "
        "plain XLA)", ck, None,
        library_call="none: no single PyTorch call re-ranks and fits",
        fits=ck["fits"],
        **{k: sum(s[k] for s in shapes) / len(shapes)
           for k in ("ms", "plain_ms", "bound_ms")}))
    print(json.dumps({"pipeline": runs, "phase_seconds": seconds,
                      "seconds": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
