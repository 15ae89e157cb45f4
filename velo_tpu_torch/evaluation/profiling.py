"""Tracing / profiling of the port: stage marks, spans, counters and a
Chrome-trace exporter.

  * ``stage(name)`` -- one stage of the odometry step (``STAGES``).  While
    the current stream is being captured into a CUDA graph it enqueues the
    stage's mark, an empty kernel ``velo_stage_<name>``
    (``csrc/stage_mark.cu``), so that every replay of the graph shows on
    the device trace's clock where each stage begins: a mark opens a stage
    and the stage lasts until the next mark (leaving a nested stage
    re-enqueues the enclosing one's mark).  ``stage_end()`` enqueues
    ``velo_stage_end`` at the end of a captured step.  Outside a capture
    (the eager step, the CPU) a stage is a ``torch.profiler`` range
    ``velo.stage.<name>``, opened only while a profiler is active;
  * ``span(name)`` -- a ``record_function`` range, opened only while a
    profiler is active (``velo.graphs.*``, ``velo.bin_scan_host``);
  * ``add`` / ``counters()`` -- process-wide counters of events and host
    seconds (``graphs.launch``: each unprofiled ``graph.replay()``;
    ``lm.kernel`` / ``lm.plain``: each LM solve ``solve/icp._solve`` runs
    as one ``lm_lidar`` or ``lm_joint`` launch or on the plain path;
    ``fit.kernel`` / ``fit.plain``: each correspondence fit of an outer
    iteration, ``solve/icp._fit``, as one ``corr_fit`` launch or plain;
    ``kernel.<name>``: each launch of one of the port's CUDA kernels,
    ``kernels/_build.KERNELS``, a batched call one; all counted when the
    Python runs: eagerly, or at a graph's warm-up and capture, never inside
    a replay);
  * ``trace`` -- context manager around ``torch.profiler`` that writes a
    Chrome trace (``chrome://tracing``, Perfetto) of the card's kernels and
    the host's calls.
"""
from __future__ import annotations

import contextlib
import os

import torch

# The stages of ``odometry.step`` in the order they run, then the end mark;
# index i is kernel i of ``csrc/stage_mark.cu``.
STAGES = ("lidar_front", "vision_front", "solve", "search", "hash_build",
          "hash_query", "map_refine", "map_update", "vision_book", "carry")
MARKS = STAGES + ("end",)
MARK_PREFIX = "velo_stage_"

_open: list[str] = []  # the stages open in the capture, innermost last
_counters: dict[str, list] = {}  # name -> [count, seconds]


def profiler_active() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) is recording."""
    return torch._C._autograd._profiler_enabled()


def capturing() -> bool:
    """Whether the current CUDA stream is being captured into a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def launch_mark(name: str) -> None:
    """Enqueue mark ``name`` (of ``MARKS``) on the current CUDA stream.  A
    mark is not counted as a ``kernel.*`` launch: those counters count the
    compute kernels, and a mark computes nothing."""
    from velo_tpu_torch.kernels import _build  # which imports this module

    err = _build.STAGE_MARK(MARKS.index(name),
                            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"stage mark {name}: CUDA error {err}")


def warm_marks() -> None:
    """Launch every mark once on the current stream, outside any capture:
    loads their module, which a capture must not do lazily."""
    for name in MARKS:
        launch_mark(name)


@contextlib.contextmanager
def span(name: str):
    """A ``record_function`` range ``name`` while a profiler is active;
    nothing otherwise."""
    if not profiler_active():
        yield
        return
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def stage(name: str):
    """The ``with`` body as stage ``name`` of ``STAGES`` (module doc)."""
    if not capturing():
        with span(f"velo.stage.{name}"):
            yield
        return
    launch_mark(name)
    _open.append(name)
    try:
        yield
    finally:
        _open.pop()
    if _open:
        launch_mark(_open[-1])


def stage_end() -> None:
    """In a capture: enqueue the end mark, which closes the step's last
    stage.  Nothing otherwise."""
    if capturing():
        launch_mark("end")


def add(name: str, seconds: float = 0.0) -> None:
    """Count one event of ``name`` taking ``seconds``."""
    c = _counters.setdefault(name, [0, 0.0])
    c[0] += 1
    c[1] += seconds


def counters() -> dict[str, tuple[int, float]]:
    """{name: (count, summed seconds)} since the process started."""
    return {k: (n, s) for k, (n, s) in _counters.items()}


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
