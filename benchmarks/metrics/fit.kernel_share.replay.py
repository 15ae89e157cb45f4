"""fit.kernel_share.replay (frame loop stages, program counter): the share
of the step's correspondence fits that ran as one ``corr_fit`` kernel
launch, ``fit.kernel / (fit.kernel + fit.plain)`` of
``velo_tpu_torch.evaluation.profiling.counters()`` (counted where
``solve/icp._fit`` routes a fit: at the graphs' warm-ups and captures);
None for a program without these counters."""


def read(run):
    if run["kind"] != "replay":
        return None
    from velo_tpu_torch.evaluation import profiling

    counters = getattr(profiling, "counters", None)
    c = counters() if counters else {}
    kernel = c.get("fit.kernel", (0, 0.0))[0]
    plain = c.get("fit.plain", (0, 0.0))[0]
    return kernel / (kernel + plain) if kernel + plain else None
