"""hash_search_roofline (correspondence search, device trace): the
voxel-hash search's share of its roofline over the profiled frames: the
least time of its bytes (``benchmarks/roofline/voxel_hash.py``) over the
card time of stages ``hash_build`` and ``hash_query``; None where the
trace has neither (a program without the marks, or the dense engine)."""
from benchmarks.metrics._stages import split_ms
from benchmarks.roofline import voxel_hash

STAGES = ("hash_build", "hash_query")


def read(run):
    split = split_ms(run)
    if split is None or not any(s in split for s in STAGES):
        return None
    measured_ms = sum(split.get(s, 0.0) for s in STAGES)
    least_ms = 1e3 * voxel_hash.frame_least_seconds(run["cfg"])
    if measured_ms <= 0 or least_ms <= 0:
        return None
    return 100.0 * least_ms / measured_ms
