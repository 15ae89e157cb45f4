"""stage.vision_front_ms.replay (frame loop stages inside the captured step,
device trace): card milliseconds per profiled frame in stage ``vision_front``:
pyramid, KLT (``klt_l0``), pre-gate; fused only."""
from benchmarks.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "vision_front")
