"""dist_topk_roofline (kernels, device trace): the ``dist_topk`` kernel's
share of its roofline over the profiled frames."""
from benchmarks.metrics._roofline import share_pct
from benchmarks.roofline import dist_topk


def read(run):
    return share_pct(run, "dist_topk", dist_topk.frame_least_seconds)
