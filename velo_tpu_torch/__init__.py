"""velo_tpu_torch — the PyTorch + CUDA port of ``velo_tpu``.

The JAX package ``velo_tpu`` stays the reference; this package mirrors its
sub-packages and function names (``geom``, ``lidar``, ``mapping``, ``solve``,
``vision``, ``pipeline``, ``io``, ``evaluation``, with ``kernels`` in place
of ``pallas``) and imports ``torch``, never ``jax`` and nothing of
``velo_tpu``: the framework-free modules it needs (``config``,
``io.fixtures``, ``evaluation.kitti_metric``) are its own copies.
Functions take tensors on an explicit device and keep the reference's
layouts at their interfaces: float32 points and images, bool masks and
int32 indices.

Five hand-written CUDA C++ kernels for sm_90a, built at first use from
``csrc/`` (``kernels/_build``): ``kernels.dist_topk`` (candidate search)
and ``kernels.klt_l0`` (level-0 KLT with ``klt_impl="pallas"``), the
counterparts of the reference's two Pallas kernels, ``kernels.lm_lidar``
and ``kernels.lm_joint`` (one launch per LM solve of the LiDAR-only and
of the joint LiDAR-visual system) and ``kernels.corr_fit`` (one launch
per ICP outer iteration's correspondence fit).  On a CPU tensor
``dist_topk`` and ``klt_l0`` run their plain PyTorch versions instead;
the LM and fit kernels take CUDA tensors only, and ``solve/icp`` keeps
the plain versions off the card.
"""
import torch as _torch

# Mirror of velo_tpu's jax_default_matmul_precision="highest": pose math is
# accuracy-critical, and TF32's 10-bit mantissa mis-ranks centimetre-scale
# near-ties just as bf16 does (velo_tpu/mapping/dense_nn.py).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
# The batched LM solves (the batch mode's vmapped step) factor and solve
# through cuSOLVER, as the single ones do: PyTorch's default sends a
# batched cholesky_solve to MAGMA, whose host-side pointer arrays a
# CUDA-graph capture refuses.  The two give the same bits on this step.
if _torch.backends.cuda.is_built():
    _torch.backends.cuda.preferred_linalg_library("cusolver")

from velo_tpu_torch import config  # noqa: E402,F401
from velo_tpu_torch.evaluation import kitti_metric  # noqa: E402,F401
from velo_tpu_torch.io import fixtures  # noqa: E402,F401

__version__ = "0.1.0"
