"""stage.carry_ms.replay (frame loop stages inside the captured step,
device trace): card milliseconds per profiled frame in stage ``carry``:
the carry's write-back inside the graph."""
from benchmarks.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "carry")
