"""kernels_per_step.fleet (captured frame loop, device trace): card
kernels in the profiled fleet window (copies and fills not counted) per
batched step.  The steps are counted by the ``velo_stage_end`` marks that
close each step's graph, not by the steps enqueued, so a trace that holds
more steps than were asked for reads the same.  A batched step launches
once per call site whatever the number of lanes."""
from benchmarks.metrics._stages import MARK


def read(run):
    trace = run["trace"]
    if run["kind"] != "fleet" or trace is None:
        return None
    kernels = [ev[0] for ev in trace.device if ev[3] == "kernel"]
    steps = sum(1 for name in kernels
                if (m := MARK.match(name)) and m.group(1) == "end")
    return len(kernels) / steps if steps else None
