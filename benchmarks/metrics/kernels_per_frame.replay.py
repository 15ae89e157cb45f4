"""kernels_per_frame.replay (captured frame loop, device trace): card
kernels in the profiled replay window (copies and fills not counted) per
frame: the count a kernel-fusion change lowers."""


def read(run):
    trace = run["trace"]
    if run["kind"] != "replay" or trace is None or not trace.frames:
        return None
    n = sum(1 for ev in trace.device if ev[3] == "kernel")
    return n / trace.frames if n else None
