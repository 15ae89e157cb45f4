"""Shared by the kernels' roofline readers: the least time of the work
the profiled frames needed (``benchmarks/roofline``, from the shapes the
configuration fixes) over the measured time of the kernel's launches in
the trace, as a percentage."""


def share_pct(run, kernel: str, frame_least_seconds):
    trace = run["trace"]
    if trace is None or not trace.frames:
        return None
    measured = sum(ev[2] for ev in trace.device
                   if ev[3] == "kernel" and kernel in ev[0]) * 1e-9
    least = trace.frames * frame_least_seconds(run["cfg"])
    if measured <= 0 or least <= 0:
        return None
    return 100.0 * least / measured
