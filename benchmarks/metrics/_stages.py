"""Shared by the stage readers: the card's milliseconds per profiled frame
in each stage of the captured odometry step.

The program marks where each stage begins with an empty kernel
``velo_stage_<stage>`` inside the captured graph, and the step's end with
``velo_stage_end`` (``velo_tpu_torch/evaluation/profiling.py``).  Walking
the trace's device operations in start order, each operation (kernel, copy
or fill; the marks themselves excluded) belongs to the stage the last mark
opened; one after ``velo_stage_end``, or before the first mark, belongs to
``outside`` (the copy-in, the result's copy).  A trace without marks (a
program without them) gives None."""
import re

MARK = re.compile(r"velo_stage_([a-z_]+)")


def split_ms(run):
    """{stage: summed milliseconds per profiled frame}, with ``outside``,
    or None."""
    trace = run["trace"]
    if run["kind"] != "replay" or trace is None or not trace.frames:
        return None
    totals, current, marked = {"outside": 0}, "outside", False
    for name, _, dur, _ in sorted(trace.device, key=lambda e: e[1]):
        m = MARK.match(name)
        if m:
            marked = True
            current = "outside" if m.group(1) == "end" else m.group(1)
            totals.setdefault(current, 0)
        else:
            totals[current] = totals.get(current, 0) + dur
    if not marked:
        return None
    return {k: v * 1e-6 / trace.frames for k, v in totals.items()}


def stage_ms(run, stage: str):
    """Milliseconds per profiled frame in ``stage``; None where the trace
    has no marks or none of that stage."""
    split = split_ms(run)
    return None if split is None else split.get(stage)
