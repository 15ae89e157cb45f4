"""lm_lidar_roofline (kernels, device trace): the ``lm_lidar`` kernel's
share of its roofline over the profiled frames (float64 operations
against the card's float64 peak)."""
from benchmarks.metrics._roofline import share_pct
from benchmarks.roofline import lm_lidar


def read(run):
    return share_pct(run, "lm_lidar", lm_lidar.frame_least_seconds)
