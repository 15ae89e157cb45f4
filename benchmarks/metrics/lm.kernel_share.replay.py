"""lm.kernel_share.replay (frame loop stages, program counter): the share
of the step's LM solves that ran as one ``lm_lidar`` kernel launch,
``lm.kernel / (lm.kernel + lm.plain)`` of
``velo_tpu_torch.evaluation.profiling.counters()`` (counted where
``solve/icp._solve`` routes a solve: at the graphs' warm-ups and
captures); None for a program without these counters."""


def read(run):
    if run["kind"] != "replay":
        return None
    from velo_tpu_torch.evaluation import profiling

    counters = getattr(profiling, "counters", None)
    c = counters() if counters else {}
    kernel = c.get("lm.kernel", (0, 0.0))[0]
    plain = c.get("lm.plain", (0, 0.0))[0]
    return kernel / (kernel + plain) if kernel + plain else None
