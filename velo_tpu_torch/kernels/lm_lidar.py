"""One launch per Levenberg-Marquardt solve of the 6-DoF LiDAR system.

``lm_lidar`` computes what ``solve/lm.lm_solve`` computes with the staged
observability prior of ``solve/icp`` (``prior_obs_impl="staged"``) for one
set of fixed point-to-line and point-to-plane correspondences: every
iteration's LiDAR build, the prior's eigenbasis, the damped Cholesky step,
the trial cost and the accept / reject decision, as one launch of the
CUDA kernel ``csrc/lm_lidar.cu`` (one thread block per solve) in place of
~5,650 small kernels.  It takes CUDA tensors only; its plain version,
:func:`lm_lidar_reference`, is the plain ``lm_solve`` on any device.

The kernel mirrors the plain path's float32 operations one for one and
computes each ``fp`` helper in float64, rounded once; only the order of the
float64 sums over the correspondences and inside the 6x6 Cholesky differs
from the libraries the plain path calls.

``icp._solve`` takes this route (``icp._kernel_route``) on the card for
the LiDAR-only system with the staged prior, no degeneracy remap and a
Huber or Cauchy loss; the same solve with the visual blocks runs as
``kernels/lm_joint``, and every other solve (the deferred loops, the
12-DoF ``ct_sweep`` solve, the CPU) stays on the plain path.

The card path is the custom operator ``velo_tpu_torch::lm_lidar`` on a
leading batch axis; under ``torch.func.vmap`` (``pipeline/batch``) its
batching rule folds the vmapped axis into that one and launches once.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from velo_tpu_torch.kernels import _build
from velo_tpu_torch.solve import lm

# The float SolverConfig fields the solve reads, passed to the operator as
# one list (lm_iters, prior_obs_stage_iters and icp_loss go on their own).
_FLOATS = ("lm_lambda_init", "lm_lambda_down", "lm_lambda_up", "converge_tol",
           "huber_delta_icp", "prior_obs_ref", "prior_obs_gain",
           "prior_deadzone_trans", "prior_deadzone_rot", "prior_obs_dz_floor")
LOSSES = ("huber", "cauchy")  # the values of icp_loss the kernel computes
_VIEWS = ("T0", "prior_inv", "w_prior", "edges", "edge_mask", "a", "b", "e_ok",
          "edge_q", "planars", "planar_mask", "n", "d", "p_ok", "planar_q")
_SYS = 43  # H (36), g (6), cost


class _View(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("s0", ctypes.c_longlong), ("s1", ctypes.c_longlong)]


class Args(ctypes.Structure):
    """``LmArgs`` of ``csrc/lm_lidar.cu``."""
    _fields_ = ([(name, _View) for name in _VIEWS]
                + [(name, ctypes.c_void_p) for name in (
                    "out_T", "out_lam", "out_cost", "out_conv", "out_last",
                    "out_nacc", "out_sys")]
                + [(name, ctypes.c_int) for name in (
                    "batch", "n_edge", "n_planar", "iters", "stage_iters",
                    "loss", "mode", "has_edge_q", "has_planar_q")]
                + [(name, ctypes.c_float) for name in (
                    "lam_init", "lam_down", "lam_up", "tol", "delta",
                    "half_delta", "cauchy_c", "obs_ref", "gain", "dz_t",
                    "dz_r", "dz_floor", "dz_span")])


def _view(x: torch.Tensor | None) -> _View:
    if x is None:
        return _View(None, 0, 0, 0)
    st = list(x.stride()) + [0, 0]
    return _View(x.data_ptr(), st[0], st[1], st[2])


def _check(tensors: dict) -> None:
    """The batched contract: the shapes of ``_VIEWS`` on one device, masks
    bool and the rest float32."""
    b = tensors["T0"].shape[0]
    ne, npl = tensors["edges"].shape[1], tensors["planars"].shape[1]
    shapes = {"T0": (b, 4, 4), "prior_inv": (b, 4, 4), "w_prior": (b, 6),
              "edges": (b, ne, 3), "a": (b, ne, 3), "b": (b, ne, 3),
              "planars": (b, npl, 3), "n": (b, npl, 3)}
    for name, x in tensors.items():
        if x is None:
            continue
        want = torch.bool if name in ("edge_mask", "e_ok", "planar_mask",
                                      "p_ok") else torch.float32
        shape = shapes.get(name, (b, ne) if name.startswith("e")
                           else (b, npl))
        if x.dtype != want or tuple(x.shape) != shape:
            raise ValueError(f"lm_lidar: {name} must be {want} of shape "
                             f"{shape}, not {x.dtype} {tuple(x.shape)}")
        if x.device != tensors["T0"].device:
            raise ValueError(f"lm_lidar: {name} is on {x.device}, T0 on "
                             f"{tensors['T0'].device}")


def args(tensors: dict, outs: dict, iters: int, stage_iters: int, loss: str,
         consts, mode: int) -> Args:
    """The kernel's arguments for batched inputs (``_VIEWS``: (B, ...)
    tensors, ``edge_q`` / ``planar_q`` may be None) and outputs
    (``out_*``: contiguous).  Each constant rounds to float32 as PyTorch
    rounds the Python number where the plain path meets it."""
    _check(tensors)
    c = dict(zip(_FLOATS, consts))
    f32 = np.float32
    delta = c["huber_delta_icp"]
    a = Args(**{name: _view(tensors[name]) for name in _VIEWS})
    for name, x in outs.items():
        setattr(a, name, x.data_ptr())
    a.batch = tensors["T0"].shape[0]
    a.n_edge, a.n_planar = tensors["edges"].shape[1], tensors["planars"].shape[1]
    a.iters, a.stage_iters = iters, stage_iters
    a.loss, a.mode = LOSSES.index(loss), mode
    a.has_edge_q = tensors["edge_q"] is not None
    a.has_planar_q = tensors["planar_q"] is not None
    a.lam_init, a.lam_down = f32(c["lm_lambda_init"]), f32(c["lm_lambda_down"])
    a.lam_up, a.tol = f32(c["lm_lambda_up"]), f32(c["converge_tol"])
    a.delta, a.half_delta = f32(delta), f32(0.5 * delta)
    a.cauchy_c = f32(0.5 * delta * delta)
    a.obs_ref, a.gain = f32(c["prior_obs_ref"]), f32(c["prior_obs_gain"])
    a.dz_t = f32(c["prior_deadzone_trans"])
    a.dz_r = f32(c["prior_deadzone_rot"])
    a.dz_floor = f32(c["prior_obs_dz_floor"])
    a.dz_span = f32(1.0 - c["prior_obs_dz_floor"])
    return a


_KERNEL = _build.Entry("lm_lidar", "lm_lidar_launch", [ctypes.POINTER(Args)])


def _outputs(b: int, device, mode: int) -> dict:
    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    if mode == 1:
        return {"out_sys": empty(b, _SYS)}
    return {"out_T": empty(b, 4, 4), "out_lam": empty(b),
            "out_cost": empty(b), "out_conv": empty(b, dtype=torch.bool),
            "out_last": empty(b), "out_nacc": empty(b, dtype=torch.int32)}


def _launch(tensors: dict, iters, stage_iters, loss, consts, mode=0) -> dict:
    """One launch for a batch of (B, ...) inputs -> the outputs."""
    t0 = tensors["T0"]
    outs = _outputs(t0.shape[0], t0.device, mode)
    a = args(tensors, outs, iters, stage_iters, loss, consts, mode)
    _KERNEL.launch(t0, ctypes.byref(a))
    return outs


@torch.library.custom_op("velo_tpu_torch::lm_lidar", mutates_args=())
def _batched(T0: torch.Tensor, prior_inv: torch.Tensor, w_prior: torch.Tensor,
             edges: torch.Tensor, edge_mask: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, e_ok: torch.Tensor,
             edge_q: Optional[torch.Tensor], planars: torch.Tensor,
             planar_mask: torch.Tensor, n: torch.Tensor, d: torch.Tensor,
             p_ok: torch.Tensor, planar_q: Optional[torch.Tensor], iters: int,
             stage_iters: int, loss: str, consts: list[float]
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor, torch.Tensor, torch.Tensor]:
    """B solves on a leading batch axis -> T (B, 4, 4), lam, cost,
    converged, last_delta, n_accept (B,): one launch (CUDA tensors only)."""
    tensors = dict(zip(_VIEWS, (T0, prior_inv, w_prior, edges, edge_mask, a,
                                b, e_ok, edge_q, planars, planar_mask, n, d,
                                p_ok, planar_q)))
    o = _launch(tensors, iters, stage_iters, loss, consts)
    return (o["out_T"], o["out_lam"], o["out_cost"], o["out_conv"],
            o["out_last"], o["out_nacc"])


@_batched.register_fake
def _(T0, *rest, **kw):
    b = T0.shape[0]
    return (T0.new_empty((b, 4, 4)), T0.new_empty((b,)), T0.new_empty((b,)),
            T0.new_empty((b,), dtype=torch.bool), T0.new_empty((b,)),
            T0.new_empty((b,), dtype=torch.int32))


_build.register_vmap(_batched)


def _consts(cfg) -> list[float]:
    return [float(getattr(cfg, name)) for name in _FLOATS]


def lm_lidar(T0, prior_inv, w_prior, edges, edge_mask, a, b, e_ok, planars,
             planar_mask, n, d, p_ok, cfg, edge_q=None,
             planar_q=None) -> lm.LMState:
    """The staged LM solve of the LiDAR system at fixed correspondences.

    Args:
      T0: (4, 4) initial pose; ``prior_inv`` (4, 4) the inverse of the
        motion prior's pose and ``w_prior`` (6,) its weights, scaled by
        ``prior_scale`` (``icp._prior_weights``).
      edges (Ne, 3), edge_mask (Ne,), a, b (Ne, 3) two points of each line,
        e_ok (Ne,); planars (Np, 3), planar_mask (Np,), n (Np, 3) unit
        normals, d (Np,) offsets, p_ok (Np,); ``edge_q`` / ``planar_q``
        optional (Ne,) / (Np,) fit-quality weights.  Masks are bool, the
        rest float32.
      cfg: the ``SolverConfig``.

    Returns the final ``lm.LMState`` of one launch, counted as
    ``kernel.lm_lidar`` in ``profiling.counters()``.  The tensors must be
    on the card (else ``ValueError``).
    """
    _KERNEL.require_cuda(T0)
    inputs = (T0, prior_inv, w_prior, edges, edge_mask, a, b, e_ok, edge_q,
              planars, planar_mask, n, d, p_ok, planar_q)
    outs = _batched(*(None if x is None else x[None] for x in inputs),
                    cfg.lm_iters, cfg.prior_obs_stage_iters, cfg.icp_loss,
                    _consts(cfg))
    return lm.LMState(*(o[0] for o in outs))


def lm_lidar_reference(T0, prior_inv, w_prior, edges, edge_mask, a, b, e_ok,
                       planars, planar_mask, n, d, p_ok, cfg, edge_q=None,
                       planar_q=None) -> lm.LMState:
    """The plain version of :func:`lm_lidar`, on any device: ``lm_solve``
    on ``icp.make_lidar_system``'s prior-less build with the staged
    prior."""
    from velo_tpu_torch.solve import icp

    build = icp.make_lidar_system(edges, edge_mask, a, b, e_ok, planars,
                                  planar_mask, n, d, p_ok, cfg, edge_q=edge_q,
                                  planar_q=planar_q)
    stage = icp.obs_stage(cfg, w_prior, prior_inv, build)
    return lm.lm_solve(None, T0, cfg, stage=stage)[1]


def system_inputs(T, edges, edge_mask, a, b, e_ok, planars, planar_mask, n,
                  d, p_ok, edge_q=None, planar_q=None) -> dict:
    """The kernel's batched inputs (B = 1) for its LiDAR build alone at T
    (``mode`` 1): the prior's slots hold T and zero weights, unread."""
    unused = torch.zeros(6, dtype=T.dtype, device=T.device)
    inputs = (T, T, unused, edges, edge_mask, a, b, e_ok, edge_q, planars,
              planar_mask, n, d, p_ok, planar_q)
    return {k: None if x is None else x[None]
            for k, x in zip(_VIEWS, inputs)}


def lidar_system(T, edges, edge_mask, a, b, e_ok, planars, planar_mask, n, d,
                 p_ok, cfg, edge_q=None, planar_q=None):
    """The kernel's LiDAR build alone at T -> (H (6, 6), g (6,), cost), as
    ``icp.make_lidar_system(...)(T)`` computes it without a prior: one
    launch (CUDA tensors only), for the card tests."""
    corr = (edges, edge_mask, a, b, e_ok, planars, planar_mask, n, d, p_ok)
    tensors = system_inputs(T, *corr, edge_q=edge_q, planar_q=planar_q)
    s = _launch(tensors, cfg.lm_iters, cfg.prior_obs_stage_iters,
                cfg.icp_loss, _consts(cfg), mode=1)["out_sys"][0]
    return s[:36].view(6, 6), s[36:42], s[42]
