"""Tracing / profiling utilities (port of
``velo_tpu/evaluation/profiling.py``).

  * ``StageTimer`` -- host wall clock per pipeline stage, fenced: a stage
    given CUDA tensors ends in ``torch.cuda.synchronize()``, so its time
    includes the card's work and not only the enqueue;
  * ``trace`` -- context manager around ``torch.profiler`` that writes a
    Chrome trace (``chrome://tracing``, Perfetto) of the card's kernels and
    the host's calls;
  * ``FrameLog`` -- accumulates per-frame records (pose, correspondence
    counts, solve cost, degeneracy flags) and dumps them to ``.npz``; a
    copy of the reference's, pure numpy.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch


class StageTimer:
    """Accumulating per-stage wall-clock timer (device-fenced)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, *fence):
        """Time the ``with`` body.  ``fence``: tensors (or nested tuples
        and lists of them) the body produces; when one lies on the card,
        the stage waits for the card before it stops the clock."""
        t0 = time.perf_counter()
        yield
        if any(x.is_cuda for x in _tensors(fence)):
            torch.cuda.synchronize()
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = max(self.counts[name], 1)
            lines.append(
                f"{name:24s} {self.totals[name]*1e3:9.2f} ms total  "
                f"{self.totals[name]/n*1e3:8.3f} ms/call  x{n}"
            )
        return "\n".join(lines)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the ``with`` body (host calls, and the card's kernels when
    there is a card) into ``<logdir>/trace.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class FrameLog:
    """Structured per-frame records -> single .npz artifact."""

    def __init__(self):
        self._rows: Dict[str, List] = defaultdict(list)

    def add(self, **fields):
        for k, v in fields.items():
            self._rows[k].append(np.asarray(v))

    def save(self, path: str):
        np.savez_compressed(
            path, **{k: np.stack(v) for k, v in self._rows.items()}
        )

    def as_dict(self):
        return {k: np.stack(v) for k, v in self._rows.items()}
