"""device_idle_pct.online (device, device trace): 100 x (1 - the seconds
in which a device operation ran / the profiled online window's seconds)."""
from benchmarks import harness


def read(run):
    trace = run["trace"]
    if run["kind"] != "online" or trace is None or not trace.device:
        return None
    return 100.0 * (1.0 - harness.busy_seconds(trace.device) / trace.window_s)
