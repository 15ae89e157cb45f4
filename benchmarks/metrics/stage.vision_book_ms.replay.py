"""stage.vision_book_ms.replay (frame loop stages inside the captured step,
device trace): card milliseconds per profiled frame in stage ``vision_book``:
depth association and corners; fused only."""
from benchmarks.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "vision_book")
