"""frame_ms_p95 (end to end, host clock): the 95th percentile over every
sweep of the window of the time from the hand-over of the raw sweep until
its pose is on the host.  Online cells."""
from benchmarks import harness


def read(run):
    if not run.get("latency_s"):
        return None
    return 1e3 * harness.percentile(run["latency_s"], 95)
