"""graphs.launch_ms.replay (captured frame loop, program counter): host
milliseconds per unprofiled ``graph.replay()``, warm-up and window
(``velo_tpu_torch.evaluation.profiling.counters()``, ``graphs.launch``; a
program without the counter gives None)."""


def read(run):
    if run["kind"] != "replay":
        return None
    from velo_tpu_torch.evaluation import profiling

    counters = getattr(profiling, "counters", None)
    n, s = (counters() if counters else {}).get("graphs.launch", (0, 0.0))
    return 1e3 * s / n if n else None
