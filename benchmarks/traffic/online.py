"""Traffic kind ``online``: one vehicle that needs each pose before the
next sweep, closed loop.

Each sweep is handed over as the raw scan a Velodyne driver gives, in
numpy: (N, 4) float32 points padded to the configuration's
``n_max_points`` rows with a far sentinel (as ``io.kitti.pad_scan`` pads
them), so every sweep hands the host binning the same number of rows.
It is binned on the host by the program's
``lidar.rangeimage.bin_scan_host``, copied to the card and stepped by
``odometry.jit_step`` (one graph replay), and its pose ``T_w`` is read
back to the host; only then does the next sweep go.  The drives
run back to back, each new one from ``init_carry``.  A sweep's latency is
the host clock from the hand-over of the raw scan until its pose is on the
host.  The card's seconds from before the copy-in to the pose (CUDA
events) are kept as ``device_s``, for the run's standard error.

Parameters: ``warm_frames`` (sweeps through the same loop in set-up:
every captured graph of the configuration), ``trace_frames`` (sweeps of
the profiled window of a ``--trace 1`` run).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


class Online:
    def __init__(self, ctx):
        from velo_tpu_torch.lidar import rangeimage
        from velo_tpu_torch.pipeline import odometry

        self.ctx, self.odo, self.bin = ctx, odometry, rangeimage.bin_scan_host
        n_max = ctx.cfg.n_max_points
        self.scans = []
        for scan in ctx.drive.scans:
            padded = np.full((n_max, 4), 1e6, np.float32)
            padded[:min(len(scan), n_max)] = scan[:n_max]
            self.scans.append(padded)
        self.n = len(self.scans)
        self.seq, self.pos, self.carry = -1, self.n, None
        self.out = {}  # sequence -> [pose (4, 4) numpy]
        self.span = contextlib.nullcontext  # a profiler's record_function
        # The host sleeps until the card is done, as a node that shares its
        # cores would, instead of spinning on a core the driver needs.
        self.done = self.begin = None
        if ctx.cuda:
            self.done = torch.cuda.Event(blocking=True, enable_timing=True)
            self.begin = torch.cuda.Event(enable_timing=True)
        self.device_s = []

    def sweep(self):
        """One sweep through the loop -> (latency, binning, step) seconds."""
        cfg, dev = self.ctx.cfg, self.ctx.device
        if self.pos == self.n:
            self.seq, self.pos = self.seq + 1, 0
            self.carry = self.odo.init_carry(cfg, dev)
        scan = self.scans[self.pos]
        t0 = time.perf_counter()
        with self.span("bench.bin_scan_host"):
            grid, valid = self.bin(scan, cfg.lidar)
        t1 = time.perf_counter()
        if self.begin is not None:
            self.begin.record()
        with self.span("bench.jit_step"):
            self.carry, out = self.odo.jit_step(
                self.carry, torch.from_numpy(grid).to(dev),
                torch.from_numpy(valid).to(dev), cfg)
        t2 = time.perf_counter()
        with self.span("bench.pose_to_host"):
            if self.done is not None:
                self.done.record()
                self.done.synchronize()
                self.device_s.append(1e-3 * self.begin.elapsed_time(
                    self.done))
            pose = out.T_w.cpu().numpy()
        t3 = time.perf_counter()
        self.out.setdefault(self.seq, []).append(pose)
        self.pos += 1
        return t3 - t0, t1 - t0, t2 - t1

    def restart(self):
        self.pos, self.out, self.device_s = self.n, {}, []

    def poses(self) -> list:
        return [np.stack(v) for _, v in sorted(self.out.items())]


def prepare(ctx) -> Online:
    o = Online(ctx)
    for _ in range(ctx.params["warm_frames"]):
        o.sweep()
    o.restart()
    return o


def window(ctx, o: Online, seconds: float) -> dict:
    lat, bin_s, step_s = [], [], []
    ctx.sync()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a, b, c = o.sweep()
        lat.append(a)
        bin_s.append(b)
        step_s.append(c)
    window_s = time.perf_counter() - t0
    return {"frames": len(lat), "window_s": window_s,
            "sequences": o.poses(), "latency_s": lat, "host_bin_s": bin_s,
            "host_step_s": step_s, "device_s": list(o.device_s)}


def profile(ctx, o: Online, frames: int):
    o.span = torch.profiler.record_function
    ctx.sync()
    t0 = time.perf_counter()
    for _ in range(frames):
        o.sweep()
    ctx.sync()
    o.span = contextlib.nullcontext
    return frames, time.perf_counter() - t0
