"""frames_per_s (end to end, host clock): every frame the window completed
over the window's seconds, from its start to the synchronise that ends
it.  Replay and fleet cells (a fleet's frames are sequence-frames: its
aggregate rate)."""
from benchmarks import harness


def read(run):
    if run["kind"] not in ("replay", "fleet"):
        return None
    return harness.rate(run["frames"], run["window_s"])
