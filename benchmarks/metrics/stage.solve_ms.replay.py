"""stage.solve_ms.replay (frame loop stages inside the captured step,
device trace): card milliseconds per profiled frame in stage ``solve``:
targets, scan-to-scan solves, redeskew, plausibility gate."""
from benchmarks.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "solve")
