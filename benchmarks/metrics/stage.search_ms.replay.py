"""stage.search_ms.replay (frame loop stages inside the captured step,
device trace): card milliseconds per profiled frame in stage ``search``:
``icp.build_candidates`` (``dist_topk``), scan-to-scan and scan-to-map."""
from benchmarks.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "search")
