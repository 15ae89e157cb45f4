"""stage.hash_build_ms.replay (frame loop stages inside the captured step,
device trace): card milliseconds per profiled frame in stage
``hash_build``: the voxel-hash grid builds of ``solve/icp._make_engine``
(``nn_engine="hash"``), nested in the solves."""
from benchmarks.metrics._stages import stage_ms


def read(run):
    return stage_ms(run, "hash_build")
