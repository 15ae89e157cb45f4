#!/usr/bin/env python3
"""The control of the correctness check: the plain reference put in the
program's place and computed one precision below what the configuration
states, against the reference itself.

The configuration states float32 values whose transcendental functions,
square roots, products, reductions and solves are computed in float64 and
rounded once (``velo_tpu_torch/fp.py``: card and CPU then agree bit for
bit).  The step below it, the one that would tempt a faster program, is
float32 throughout: the reference with ``fp.F64 = torch.float32``.

    python3 benchmarks/control.py --workload <cell> --seeds 1,2,3

puts, per seed, the control's poses of the drive's first
``compare_frames`` frames through the comparison that decides a run's
``correct`` (``harness.compare`` and ``harness.checks_pass``, the cell's
limits), against the reference's, and prints each number beside its
limit, ``correct`` and ``failed``.  Exits with 1 where the control comes
out correct on any seed.  The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import harness  # noqa: E402
from benchmarks import run as bench_run  # noqa: E402


def lower_precision():
    """Switch the reference's float64 intermediates to float32; returns
    the function that switches them back."""
    import torch

    from benchmarks.reference import fp

    fp.F64 = torch.float32
    return lambda: setattr(fp, "F64", torch.float64)


def judge(conf: dict, work: dict, drive, device) -> dict:
    """The control of ``drive``'s first ``compare_frames`` frames through
    the harness's comparison against the reference: its checks,
    ``correct`` and ``failed``, and the seconds of both."""
    frames = min(work["params"]["compare_frames"], len(drive.scans))
    t0 = time.perf_counter()
    ref = bench_run.reference_poses(conf, drive, frames, device)
    t1 = time.perf_counter()
    restore = lower_precision()
    try:
        ctl = bench_run.reference_poses(conf, drive, frames, device)
    finally:
        restore()
    t2 = time.perf_counter()
    checks, failed = harness.compare([ctl], ref, work["limits"])
    return {"correct": harness.checks_pass(checks), "failed": failed,
            "checks": checks, "frames": frames, "reference_s": t1 - t0,
            "control_s": t2 - t1}


def main(argv=None, device=None, adjust=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    import torch

    from benchmarks import drive as drive_mod

    spec = harness.benchmark()
    _, conf_entry = harness.cell(spec, args.workload)
    conf = harness.config_file(conf_entry)
    work = harness.workload_file(args.workload)
    if adjust is not None:
        adjust(conf, work)
    if device is None:
        if not torch.cuda.is_available():
            print("control: no CUDA device", file=sys.stderr)
            return 3
        device = "cuda"
    fooled = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        drive = drive_mod.simulate(conf, seed, device)
        row = judge(conf, work, drive, torch.device(device))
        fooled += row["correct"]
        for name, c in row["checks"].items():
            bound = (f"limit {c['limit']!r}" if "limit" in c
                     else f"at least {c['at_least']!r}")
            print(f"control {args.workload} seed {seed} check {name}: "
                  f"{c['value']!r} {bound}", file=sys.stderr)
        print(json.dumps({"workload": args.workload, "seed": seed, **row}),
              flush=True)
    return 1 if fooled else 0


if __name__ == "__main__":
    sys.exit(main())
