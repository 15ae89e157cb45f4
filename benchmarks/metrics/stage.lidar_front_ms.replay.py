"""stage.lidar_front_ms.replay (frame loop stages inside the captured step,
device trace): card milliseconds per profiled frame in stage ``lidar_front``:
range image or deskew, curvature, features, the predicted motion."""
from benchmarks.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "lidar_front")
