"""stage.hash_query_ms.replay (frame loop stages inside the captured step,
device trace): card milliseconds per profiled frame in stage
``hash_query``: the voxel-hash queries of ``solve/icp._make_engine``
(``nn_engine="hash"``), one per target set and outer iteration."""
from benchmarks.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "hash_query")
