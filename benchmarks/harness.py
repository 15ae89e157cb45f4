"""The data-driven parts of the benchmark: finding a cell's files by name,
building its configuration, the statistics, the reading of a profiler
trace, and the comparison that decides ``correct``.

Layout (every piece is found by the name ``BENCHMARK.json`` gives it, so a
later change adds files and edits none):

* ``configs/<config>.json``: one deployment; ``velo_config`` spells out
  every field of the program's ``VeloConfig`` (a file that lacks one or
  names an unknown one is refused), ``drive`` the simulated drive;
* ``workloads/<cell>.json``: one cell: its configuration, its traffic
  kind and parameters, and the limits of its correctness check;
* ``traffic/<kind>.py``: one traffic driver (``prepare``, ``window``,
  ``profile``);
* ``metrics/<metric>.py``: one reader per metric, ``read(run)`` -> a
  number, or None where it finds nothing to read;
* ``drive/``, ``roofline/``, ``reference/``: the frozen simulator, the
  kernels' work and the card's peaks, and the plain reference.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import re
import sys
from pathlib import Path
from types import ModuleType

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
# Top-level module names that no process of the benchmark may load,
# compared whole (the program's own name begins with the last one).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "velo_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(spec: dict, name: str) -> tuple[dict, dict]:
    """(workload entry, config entry) of cell ``name`` in ``spec``."""
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    return w, next(c for c in spec["configs"] if c["name"] == w["config"])


def metrics_of(spec: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell_name`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones.  A metric without a
    ``workloads`` key is reported in every cell (a per-layer one in every
    cell that reports the end-to-end metric it moves)."""
    def listed(m):
        return "workloads" not in m or cell_name in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def plugin(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """``benchmarks/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / "benchmarks" / kind / f"{name}.py"
    if not NAME.match(name) or not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    mod_name = f"benchmarks.{kind}._{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def build_config(config_module: ModuleType, fields: dict):
    """``config_module.VeloConfig`` from ``fields``, which must name every
    field of it and of its four groups, and nothing else."""
    def build(cls, values, where):
        names = {f.name for f in dataclasses.fields(cls)}
        missing, unknown = names - set(values), set(values) - names
        if missing or unknown:
            raise ValueError(
                f"{where}: missing {sorted(missing)}, unknown {sorted(unknown)}")
        default, kw = cls(), {}
        for f in dataclasses.fields(cls):
            v, d = values[f.name], getattr(default, f.name)
            kw[f.name] = (build(type(d), v, f"{where}.{f.name}")
                          if dataclasses.is_dataclass(d) else v)
        return cls(**kw)

    return build(config_module.VeloConfig, fields, "velo_config")


def config_file(entry: dict, root: Path = ROOT) -> dict:
    doc = load_json(root / entry["file"])
    if doc.get("name") != entry["name"]:
        raise ValueError(f"{entry['file']} names {doc.get('name')!r}")
    return doc


def workload_file(name: str, root: Path = ROOT) -> dict:
    doc = load_json(root / "benchmarks" / "workloads" / f"{name}.json")
    if doc.get("name") != name:
        raise ValueError(f"workloads/{name}.json names {doc.get('name')!r}")
    return doc


# ---------------------------------------------------------------- statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of ``values``, linear between the two
    nearest ranks (numpy's default)."""
    if not len(values):
        raise ValueError("percentile of no values")
    return float(np.percentile(np.asarray(values, np.float64), q))


def rate(count: int, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("rate over no time")
    return count / seconds


# --------------------------------------------------------------- the trace


# The kinds of device activity that occupy the card.  A range of a
# ``record_function`` also shows on the device's timeline, spanning the
# work it launched and the gaps between: it is not counted.
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# The kernel of ``torch.cuda._sleep``, which no captured graph holds: a
# traffic driver enqueues one before and one after the frames it has
# profiled, and only what ran between the two is read.
MARKER = "spin_kernel"


@dataclasses.dataclass
class Trace:
    """What a profiled window holds: device operations (name, start ns,
    duration ns, kind), host events (name, start ns, duration ns), the
    window's seconds and the frames it ran."""
    device: list
    host: list
    window_s: float
    frames: int


def read_profile(prof, window_s: float, frames: int) -> Trace:
    """The raw Kineto events of a ``torch.profiler`` run: building
    ``prof.events()`` would first make a Python object for each of the
    hundreds of thousands of events of a profiled frame.  The profiler sees
    the kernels inside a replayed CUDA graph one by one."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host = [(ev.name(), ev.start_ns(), ev.duration_ns()) for ev in events
            if ev.device_type() != cuda]
    device = [(ev.name(), ev.start_ns(), ev.duration_ns()) for ev in events
              if ev.device_type() == cuda]
    return trace_of(device, host, window_s, frames)


def trace_of(device, host, window_s: float, frames: int) -> Trace:
    """A ``Trace`` from device events (name, start ns, duration ns): each
    given its kind, annotations dropped; where two ``MARKER`` kernels
    bracket the profiled frames, only what lies between them, and the
    window is the device's time from the end of the first to the start of
    the last."""
    spans = {h[0] for h in host}
    device = [(n, s, d, kind_of(n, spans)) for n, s, d in device]
    device = [e for e in device if e[3] in DEVICE_KINDS]
    marks = sorted((s, s + d) for n, s, d, _ in device if MARKER in n)
    if len(marks) < 2:
        return Trace(device, host, window_s, frames)
    lo, hi = marks[0][1], marks[-1][0]

    def clip(events):
        out = []
        for n, s, d, *rest in events:
            a, b = max(s, lo), min(s + d, hi)
            if b > a or (d == 0 and lo <= s <= hi):
                out.append((n, a, b - a, *rest))
        return out

    device = [e for e in clip(device) if MARKER not in e[0]]
    return Trace(device, clip(host), (hi - lo) * 1e-9, frames)


def kind_of(name: str, host_names) -> str:
    """The kind of a device event, by its name: the Kineto events of the
    card's PyTorch build carry no kind.  An annotation bears the name of
    the host range it mirrors; copies and fills are named ``Memcpy ...``
    and ``Memset ...``."""
    if name in host_names:
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def busy_seconds(events) -> float:
    """Seconds in which at least one device operation ran."""
    total, end = 0, None
    for _, s, d, *_ in sorted(events, key=lambda e: e[1]):
        e = s + d
        if end is None or s > end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-9


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps of the device by what the host was doing then (the innermost
    host span open at the gap's middle)."""
    by_name: dict = {}
    for name, _, d, _ in trace.device:
        by_name[name] = by_name.get(name, 0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], None
    for _, s, d, _ in sorted(trace.device, key=lambda e: e[1]):
        if end is not None and s > end:
            gaps.append((end, s - end))
        end = s + d if end is None else max(end, s + d)
    gaps = sorted(gaps, key=lambda g: -g[1])[:top]
    spans = sorted(trace.host, key=lambda e: e[1])
    idle = []
    for start, length in gaps:
        mid = start + length // 2
        inner = [h for h in spans if h[1] <= mid < h[1] + h[2]]
        label = min(inner, key=lambda h: h[2])[0] if inner else "no host span"
        idle.append([label[:160], length * 1e-9])
    return {"device_ops": [[n[:160], d * 1e-9] for n, d in ops],
            "idle_gaps": idle}


# ------------------------------------------------------------ correctness


def pose_gaps(program: np.ndarray, reference: np.ndarray):
    """Per pose: translation distance (m) and rotation angle (deg) between
    (..., 4, 4) program and reference poses, in float64."""
    p = np.asarray(program, np.float64)
    r = np.asarray(reference, np.float64)
    dt = np.linalg.norm(p[..., :3, 3] - r[..., :3, 3], axis=-1)
    rel = np.einsum("...ji,...jk->...ik", r[..., :3, :3], p[..., :3, :3])
    # The angle from the skew part and the trace together: exactly 0 for
    # equal matrices (arccos of the trace alone reads ~0.03 deg there,
    # since float32 rotations are orthonormal only to rounding).
    skew = rel - np.swapaxes(rel, -1, -2)
    sin2 = np.linalg.norm(np.stack([skew[..., 2, 1], skew[..., 0, 2],
                                    skew[..., 1, 0]], axis=-1), axis=-1)
    cos2 = np.trace(rel, axis1=-2, axis2=-1) - 1.0
    return dt, np.degrees(np.arctan2(sin2, cos2))


def compare(sequences, reference, limits: dict) -> dict:
    """The numbers that decide ``correct``: every pose of every sequence
    the window ran that the reference covers (its first frames), against
    the reference's poses of that sequence's drive, and every pose of the
    window for finiteness.

    ``sequences``: list of (F_i, 4, 4) pose arrays, each from frame 0 of
    drive 0, or of (drive, poses) pairs.  ``reference``: the reference's
    (K, 4, 4) poses of drive 0, or a list of them, one per drive.  Returns
    {name: {"value", "limit"}} and the count of failed poses."""
    refs = reference if isinstance(reference, (list, tuple)) else [reference]
    gap_m, gap_deg, compared, failed, nonfinite = 0.0, 0.0, 0, 0, 0
    for item in sequences:
        drive, poses = item if isinstance(item, tuple) else (0, item)
        ref = refs[drive]
        poses = np.asarray(poses, np.float64)
        bad = ~np.isfinite(poses).all(axis=(-1, -2))
        nonfinite += int(bad.sum())
        head = poses[:ref.shape[0]]
        if not len(head):
            continue
        dt, dr = pose_gaps(head, ref[:len(head)])
        dt = np.where(np.isfinite(dt), dt, np.inf)
        dr = np.where(np.isfinite(dr), dr, np.inf)
        failed += int(((dt > limits["pose_gap_m"])
                       | (dr > limits["rot_gap_deg"])).sum())
        compared += len(head)
        gap_m, gap_deg = max(gap_m, float(dt.max())), max(gap_deg,
                                                          float(dr.max()))
    checks = {
        "pose_gap_m": {"value": gap_m, "limit": limits["pose_gap_m"]},
        "rot_gap_deg": {"value": gap_deg, "limit": limits["rot_gap_deg"]},
        "nonfinite_poses": {"value": nonfinite, "limit": 0},
        "poses_compared": {"value": compared, "at_least": 1},
    }
    return checks, failed + nonfinite


def checks_pass(checks: dict) -> bool:
    """Every number within its limit (``limit``: at most; ``at_least``)."""
    return all(math.isfinite(c["value"]) and (
        c["value"] <= c["limit"] if "limit" in c else
        c["value"] >= c["at_least"]) for c in checks.values())


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})
