"""``odometry.run_scan`` on the fused drive (``klt_impl="pallas"``, the
``klt_l0`` kernel's plain version at level 0) against
``velo_tpu.pipeline.odometry.run_scan`` over 3 frames, within the
end-to-end gate of 5 cm / 0.1 deg.  Apart from ``test_torch_run_scan.py``
because JAX compiles the fused scan for ~50 s on the CPU."""
import torch

from test_torch_run_scan import (assert_poses_close, config, drive,  # noqa: F401
                                 jax_scan, port_scan)

torch.set_num_threads(1)


def test_run_scan_against_jax_fused(drive):  # noqa: F811
    cfg = config(True)
    _, out = port_scan(drive, cfg)
    assert_poses_close(out.T_w.numpy(), jax_scan(drive, cfg))
