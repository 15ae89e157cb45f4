"""graphs.host_ms.online (captured frame loop, host clock): mean host time
of a sweep's copy to the card and its ``jit_step`` call (the graph
replay's launch), before the pose is read, over the window."""


def read(run):
    step = run.get("host_step_s")
    if not step:
        return None
    return 1e3 * sum(step) / len(step)
