#!/usr/bin/env python3
"""Benchmark of ``velo_tpu_torch`` (LiDAR and LiDAR-visual odometry) on
the card:

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  One run: load the cell's files by the names
``BENCHMARK.json`` gives; simulate the drive from ``--seed`` on the card
(a cell whose parameters give ``sequences`` B > 1: one drive per sequence,
lane i's from ``--seed`` + i);
prepare the cell's traffic and warm it up through the timed entry (which
builds the kernels into the checkout's ``velo_tpu_torch/_build/`` on the
first run and captures the cell's CUDA graphs); measure for ``--seconds``;
with ``--trace 1`` profile a few more frames of the same traffic; then,
with the program's state freed, run the plain reference over the first
frames of each drive and compare every pose the window produced for them
with its own drive's.
The last lines of standard error are the compared numbers beside their
limits; the last line of standard output is one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and
``breakdown`` and ``checks``).  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer ones.

Exits with 3 and prints no result without a card (or with fewer cards
than the cell asks for), and with 4 when JAX or the JAX package is loaded
once the window has closed.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path


def _process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


T_START = time.perf_counter() - _process_age_s()
ROOT = Path(__file__).resolve().parent.parent
# Every cache of the program and of its libraries at a fixed path inside
# the checkout, so that only a checkout's first run builds anything.
_CACHE = ROOT / ".bench_cache"
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(_CACHE / _sub)
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import harness  # noqa: E402


class Context:
    """What a traffic driver and a metric reader see of the run."""

    def __init__(self, cfg, params, device, drives):
        import torch

        self.cfg, self.params = cfg, params
        self.device = torch.device(device)
        self.drives, self.drive = drives, drives[0]
        self.cuda = self.device.type == "cuda"

    def sync(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize(self.device)

    def event(self):
        """A marker of the work enqueued so far (``synchronize()`` waits
        for it; ``elapsed_time(later)`` gives the card's milliseconds
        between two)."""
        import torch

        if not self.cuda:
            return _Done()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def mark(self):
        """Enqueue a ``harness.MARKER`` kernel (none on the CPU)."""
        import torch

        if self.cuda:
            torch.cuda._sleep(1)


class _Done:
    def synchronize(self):
        pass


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def simulate_drives(conf: dict, seed: int, lanes: int, device) -> list:
    """One drive per sequence: lane i's from ``seed + i``, so lane 0's is
    the drive that a single-sequence cell of the same seed simulates."""
    from benchmarks import drive as drive_mod

    return [drive_mod.simulate(conf, seed + i, device) for i in range(lanes)]


def reference_poses(conf: dict, drive, frames: int, device):
    """The plain reference's poses for the drive's first ``frames``
    sweeps: binned by its own copy of the host binning, stepped eagerly
    from its own initial carry."""
    import numpy as np
    import torch

    from benchmarks.reference import config as rconfig
    from benchmarks.reference.geom import camera
    from benchmarks.reference.lidar import rangeimage
    from benchmarks.reference.pipeline import odometry

    cfg = harness.build_config(rconfig, conf["velo_config"])
    binned = [rangeimage.bin_scan_host(s, cfg.lidar)
              for s in drive.scans[:frames]]
    grids = torch.from_numpy(np.stack([g for g, _ in binned])).to(device)
    masks = torch.from_numpy(np.stack([m for _, m in binned])).to(device)
    images = cam = None
    if cfg.use_vision:
        images = torch.from_numpy(drive.images[:frames]).to(device)
        cam = camera.from_numpy(drive.P, drive.T_cam_velo, cfg.vision.width,
                                cfg.vision.height, device=device)
    with torch.inference_mode():
        return odometry.run(grids, masks, cfg, images=images, cam=cam,
                            device=device)


def main(argv=None, device=None, adjust=None, root: Path = ROOT) -> int:
    """One run; returns the exit code.  ``device``: where to run without
    looking for a card (tests); ``adjust(conf, workload)``: edits the
    loaded configuration and workload documents in place (tests)."""
    args = parse(argv)
    spec = harness.benchmark(root)
    entry, conf_entry = harness.cell(spec, args.workload)
    conf = harness.config_file(conf_entry, root)
    work = harness.workload_file(args.workload, root)
    if adjust is not None:
        adjust(conf, work)

    import torch

    if device is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < entry["chips"]:
            print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
                  f"found {found}", file=sys.stderr)
            return 3
        device = "cuda"

    import velo_tpu_torch
    from velo_tpu_torch.pipeline import graphs

    traffic = harness.plugin("traffic", work["kind"], root)
    cfg = harness.build_config(velo_tpu_torch.config, conf["velo_config"])
    t_drive = time.perf_counter()
    drives = simulate_drives(conf, args.seed,
                             work["params"].get("sequences", 1), device)
    ctx = Context(cfg, work["params"], device, drives)
    t_prepare = time.perf_counter()
    state = traffic.prepare(ctx)
    ctx.sync()
    t_window = time.perf_counter()
    stages = {"imports_s": t_drive - T_START, "drive_s": t_prepare - t_drive,
              "prepare_s": t_window - t_prepare}
    run = traffic.window(ctx, state, args.seconds)
    run["setup_s"] = t_window - T_START
    trace = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if ctx.cuda else [])
        with profile(activities=acts) as prof:
            frames, secs = traffic.profile(ctx, state,
                                           work["params"]["trace_frames"])
        trace = harness.read_profile(prof, secs, frames)
        del prof
    memory_peak = (torch.cuda.max_memory_allocated(ctx.device)
                   if ctx.cuda else 0)
    run["captures"] = graphs.captures()
    del state
    graphs.release()
    gc.collect()
    if ctx.cuda:
        torch.cuda.empty_cache()

    k = min(work["params"]["compare_frames"], len(ctx.drive.scans))
    t_ref = time.perf_counter()
    refs = [reference_poses(conf, d, k, ctx.device) for d in drives]
    ref_s = time.perf_counter() - t_ref
    checks, failed = harness.compare(run["sequences"], refs, work["limits"])
    correct = harness.checks_pass(checks)

    run.update(cfg=cfg, trace=trace, kind=work["kind"])
    metrics = {}
    for m in harness.metrics_of(spec, args.workload, bool(args.trace)):
        value = harness.plugin("metrics", m["name"], root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if ctx.cuda else ctx.device.type,
                "kind": (torch.cuda.get_device_name(ctx.device) if ctx.cuda
                         else "cpu"),
                "count": entry["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": run["frames"],
              "failed": failed, "metrics": metrics, "device": dev_info}
    if trace is not None:
        from benchmarks import roofline

        dev_info["busy_s"] = harness.busy_seconds(trace.device)
        dev_info["window_s"] = trace.window_s
        dev_info["power_limit_w"] = roofline.power_limit_w()
        result["breakdown"] = harness.breakdown(trace)
    result["checks"] = checks
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in the benchmark's process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(f"{args.workload} seed {args.seed}: {run['frames']} frames in "
          f"{run['window_s']:.3f} s, set-up {run['setup_s']:.3f} s, "
          f"{len(run['sequences'])} sequence(s); reference over {k} frames "
          f"of {len(drives)} drive(s) in {ref_s:.3f} s",
          file=sys.stderr)
    print("set-up " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()),
          file=sys.stderr)
    for key in ("host_enqueue_s", "host_wait_s"):
        if key in run:
            print(f"{key} {run[key]:.3f}", file=sys.stderr)
    for key in ("latency_s", "host_bin_s", "host_step_s", "device_s",
                "device_chunk_s"):
        if run.get(key):
            v = run[key]
            thirds = [v[i * len(v) // 3:(i + 1) * len(v) // 3]
                      for i in range(3)]
            print(f"{key} ms p50 {1e3 * harness.percentile(v, 50):.3f}"
                  f" p95 {1e3 * harness.percentile(v, 95):.3f} max "
                  f"{1e3 * max(v):.3f}; p50 by thirds of the window " +
                  " ".join(f"{1e3 * harness.percentile(t, 50):.3f}"
                           for t in thirds if t), file=sys.stderr)
    for name, c in checks.items():
        bound = (f"limit {c['limit']!r}" if "limit" in c
                 else f"at least {c['at_least']!r}")
        print(f"check {name}: {c['value']!r} {bound}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
