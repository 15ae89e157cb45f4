"""stage.map_update_ms.replay (frame loop stages inside the captured step,
device trace): card milliseconds per profiled frame in stage ``map_update``:
velocity, re-correction, map insert and maintenance."""
from benchmarks.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "map_update")
