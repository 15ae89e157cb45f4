"""frames_per_s (end to end, host clock): every frame the window completed
over the window's seconds, from its start to the synchronise that ends
it.  Replay cells."""
from benchmarks import harness


def read(run):
    if run["kind"] != "replay":
        return None
    return harness.rate(run["frames"], run["window_s"])
