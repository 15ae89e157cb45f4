"""stage.map_refine_ms.replay (frame loop stages inside the captured step,
device trace): card milliseconds per profiled frame in stage ``map_refine``:
scan-to-map refinement, its searches excluded."""
from benchmarks.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "map_refine")
