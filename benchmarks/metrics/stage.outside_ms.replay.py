"""stage.outside_ms.replay (frame loop stages inside the captured step,
device trace): card milliseconds per profiled frame in stage ``outside``:
what the card runs outside the captured step: copy-in, the result's copy."""
from benchmarks.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "outside")
