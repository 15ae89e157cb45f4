"""One fused step with ``klt_impl="window"`` (the local-window KLT, whose
tracks freeze at the window's edge) from a shared carry against JAX's,
within the one-step gate of ``test_torch_odometry.py``, 1 cm / 0.05 deg.
Apart from ``test_torch_klt_impls.py`` because each JAX compile of a
fused step takes ~20-40 s on the CPU."""
import pytest
import torch

from test_torch_klt_impls import _pose_diff, fused_step_pair

torch.set_num_threads(1)


@pytest.mark.parametrize("frame", [0, 1])
def test_fused_step_window(frame):
    dt, dr = _pose_diff(*fused_step_pair("window", frame))
    assert dt < 0.01 and dr < 0.05, (dt, dr)
