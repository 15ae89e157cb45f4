"""klt_l0_roofline (kernels, device trace): the ``klt_l0`` kernel's share
of its roofline over the profiled frames."""
from benchmarks.metrics._roofline import share_pct
from benchmarks.roofline import klt_l0


def read(run):
    return share_pct(run, "klt_l0", klt_l0.frame_least_seconds)
