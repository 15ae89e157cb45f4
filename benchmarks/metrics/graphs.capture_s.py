"""graphs.capture_s (captured frame loop, program counter): the summed
eager warm-up and capture seconds of every CUDA graph the run captured
(``velo_tpu_torch.pipeline.graphs.captures()``)."""


def read(run):
    caps = run["captures"]
    if not caps:
        return None
    return sum(c.warm_s + c.capture_s for c in caps)
