"""One launch per Levenberg-Marquardt solve of the joint LiDAR-visual
system.

``lm_joint`` computes what ``solve/lm.lm_solve`` computes with the staged
observability prior of ``solve/icp`` for the fused scan-to-scan system,
``icp.make_lidar_system(..., vis=vis)``: every iteration's LiDAR build plus
the visual blocks of ``icp._vis_terms6`` (Huber-weighted reprojection of
the depth tracks and, where ``uv_prev`` is given and ``epi_weight > 0``,
the epipolar residual of the tracks without depth), the prior's eigenbasis
from that joint Hessian, the damped Cholesky step, the trial cost with the
visual cost included and the accept / reject decision, as one launch of
the CUDA kernel ``csrc/lm_joint.cu`` (one thread block per solve) in place
of ~6,000-8,000 small kernels.  It takes CUDA tensors only; its
plain version, :func:`lm_joint_reference`, is the plain ``lm_solve`` on any
device.

It replaces no TPU kernel: ``velo_tpu/solve/lm.py`` is plain XLA.  A
solve is a chain of dependent iterations, latency-bound on one block; the
kernel keeps the whole chain in one launch and spreads each pass's
correspondences and tracks over the block's threads (see the source).

The source includes ``csrc/lm_lidar.cu`` as it is and runs its device
functions (the LiDAR pass, the step, the accept / reject) with a visual
pass of its own, in a library of its own: the LiDAR-only kernel and its
build are untouched.  The kernel's name holds no ``lm_lidar``, so what
counts that kernel's launches and time does not count this one.  It
mirrors the plain path's float32 operations one for one and computes each
``fp`` helper and each float64 step of ``residuals.epipolar`` /
``epipolar_jacobian`` in float64, rounded where the plain path rounds.
The epipolar block's inputs that do not depend on the pose
(``T_cam_velo``'s inverse, and the tracks' normalized coordinates through
``K^-1``) are computed once per solve by the plain path's own calls
(:func:`prepare`).

``icp._solve`` takes this route (``icp._kernel_route``) on the card for
every 6-DoF solve that carries ``vis`` on the staged route; the 12-DoF
``ct_sweep`` solve, the deferred loops and the CPU stay plain.  The card
path is the custom operator ``velo_tpu_torch::lm_joint`` on a leading
batch axis; under ``torch.func.vmap`` (``pipeline/batch``) its batching
rule folds the vmapped axis into that one and launches once (inputs
shared by the lanes, such as the camera, at batch stride 0).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from velo_tpu_torch.geom import se3
from velo_tpu_torch.kernels import _build, lm_lidar
from velo_tpu_torch.solve import lm
from velo_tpu_torch.solve import residuals as res

_VIS_VIEWS = ("xyz", "obs_uv", "mask", "w_lm", "w_scale", "P", "T_cam_velo",
              "T_vc", "mask_nodepth", "x1", "x2")
_N_LIDAR = len(lm_lidar._VIEWS)


class VisArgs(ctypes.Structure):
    """``VisArgs`` of ``csrc/lm_joint.cu``."""
    _fields_ = ([(name, lm_lidar._View) for name in _VIS_VIEWS]
                + [("n_track", ctypes.c_int), ("has_epi", ctypes.c_int)]
                + [(name, ctypes.c_float) for name in (
                    "vis_weight", "epi_weight", "delta", "half_delta",
                    "min_baseline")])


class Prepared(NamedTuple):
    """The visual inputs of one solve, as the kernel reads them: the
    tensors of ``_VIS_VIEWS`` (the epipolar three None where the block is
    off) and the weight ``vis_weight`` that scales ``w_scale``."""
    xyz: torch.Tensor
    obs_uv: torch.Tensor
    mask: torch.Tensor
    w_lm: torch.Tensor
    w_scale: torch.Tensor
    P: torch.Tensor
    T_cam_velo: torch.Tensor
    T_vc: torch.Tensor
    mask_nodepth: Optional[torch.Tensor]
    x1: Optional[torch.Tensor]
    x2: Optional[torch.Tensor]
    vis_weight: float


def prepare(vis, cfg) -> Prepared:
    """``vis`` (an ``icp.VisData``) as the kernel's inputs: its pose-free
    pieces computed once, by the calls the plain path makes each
    iteration (``se3.inv`` of ``T_cam_velo``; ``res.normalized_tracks``).
    A Python-number ``w_lm`` becomes a tensor, and a Python-number
    ``w_scale`` is folded with ``vis_weight`` as Python multiplies them."""
    K = vis.xyz_prev_velo.shape[0]
    dev = vis.xyz_prev_velo.device
    w_lm = (vis.w_lm if isinstance(vis.w_lm, torch.Tensor) else torch.full(
        (K,), float(vis.w_lm), dtype=torch.float32, device=dev))
    if isinstance(vis.w_scale, torch.Tensor):
        w_scale, vis_weight = vis.w_scale, float(cfg.vis_weight)
    else:
        w_scale = torch.full((), cfg.vis_weight * vis.w_scale,
                             dtype=torch.float32, device=dev)
        vis_weight = 1.0
    mask_nodepth = x1 = x2 = None
    if vis.uv_prev is not None and cfg.epi_weight > 0:
        mask_nodepth = vis.mask_nodepth
        x1, x2 = res.normalized_tracks(vis.P[:3, :3], vis.uv_prev,
                                       vis.obs_uv)
    return Prepared(vis.xyz_prev_velo, vis.obs_uv, vis.mask, w_lm, w_scale,
                    vis.P, vis.T_cam_velo, se3.inv(vis.T_cam_velo),
                    mask_nodepth, x1, x2, vis_weight)


def _check(lidar: dict, tensors: dict) -> None:
    """The batched contract of the visual inputs: the shapes of
    ``_VIS_VIEWS`` on T0's device, masks bool, x1 and x2 float64, the rest
    float32."""
    t0 = lidar["T0"]
    b, k = t0.shape[0], tensors["xyz"].shape[1]
    shapes = {"xyz": (b, k, 3), "obs_uv": (b, k, 2), "mask": (b, k),
              "w_lm": (b, k), "w_scale": (b,), "P": (b, 3, 4),
              "T_cam_velo": (b, 4, 4), "T_vc": (b, 4, 4),
              "mask_nodepth": (b, k), "x1": (b, k, 3), "x2": (b, k, 3)}
    epi = [tensors[n] is None for n in ("mask_nodepth", "x1", "x2")]
    if any(epi) and not all(epi):
        raise ValueError("lm_joint: mask_nodepth, x1 and x2 come together")
    for name, x in tensors.items():
        if x is None:
            continue
        want = (torch.bool if name.startswith("mask") else
                torch.float64 if name in ("x1", "x2") else torch.float32)
        if x.dtype != want or tuple(x.shape) != shapes[name]:
            raise ValueError(f"lm_joint: {name} must be {want} of shape "
                             f"{shapes[name]}, not {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != t0.device:
            raise ValueError(f"lm_joint: {name} is on {x.device}, T0 on "
                             f"{t0.device}")


def vis_args(lidar: dict, tensors: dict, vconsts) -> VisArgs:
    """The kernel's visual arguments for batched inputs (``_VIS_VIEWS``:
    (B, ...) tensors) and ``vconsts`` = (vis_weight, epi_weight,
    huber_delta_repr), each rounded to float32 as PyTorch rounds the
    Python number where the plain path meets it."""
    _check(lidar, tensors)
    vis_weight, epi_weight, delta = vconsts
    f32 = np.float32
    v = VisArgs(**{name: lm_lidar._view(tensors[name])
                   for name in _VIS_VIEWS})
    v.n_track = tensors["xyz"].shape[1]
    v.has_epi = tensors["x1"] is not None
    v.vis_weight, v.epi_weight = f32(vis_weight), f32(epi_weight)
    v.delta, v.half_delta = f32(delta), f32(0.5 * delta)
    v.min_baseline = f32(res.MIN_BASELINE)
    return v


_KERNEL = _build.Entry("lm_joint", "lm_joint_launch",
                       [ctypes.POINTER(lm_lidar.Args), ctypes.POINTER(VisArgs)])


def _launch(lidar: dict, tensors: dict, iters, stage_iters, loss, consts,
            vconsts, mode=0) -> dict:
    """One launch for a batch of (B, ...) inputs -> the outputs."""
    t0 = lidar["T0"]
    outs = lm_lidar._outputs(t0.shape[0], t0.device, mode)
    a = lm_lidar.args(lidar, outs, iters, stage_iters, loss, consts, mode)
    v = vis_args(lidar, tensors, vconsts)
    _KERNEL.launch(t0, ctypes.byref(a), ctypes.byref(v))
    return outs


@torch.library.custom_op("velo_tpu_torch::lm_joint", mutates_args=())
def _batched(T0: torch.Tensor, prior_inv: torch.Tensor, w_prior: torch.Tensor,
             edges: torch.Tensor, edge_mask: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, e_ok: torch.Tensor,
             edge_q: Optional[torch.Tensor], planars: torch.Tensor,
             planar_mask: torch.Tensor, n: torch.Tensor, d: torch.Tensor,
             p_ok: torch.Tensor, planar_q: Optional[torch.Tensor],
             xyz: torch.Tensor, obs_uv: torch.Tensor, mask: torch.Tensor,
             w_lm: torch.Tensor, w_scale: torch.Tensor, P: torch.Tensor,
             T_cam_velo: torch.Tensor, T_vc: torch.Tensor,
             mask_nodepth: Optional[torch.Tensor],
             x1: Optional[torch.Tensor], x2: Optional[torch.Tensor],
             iters: int, stage_iters: int, loss: str, consts: list[float],
             vconsts: list[float]
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor, torch.Tensor, torch.Tensor]:
    """B joint solves on a leading batch axis -> T (B, 4, 4), lam, cost,
    converged, last_delta, n_accept (B,): one launch (CUDA tensors
    only)."""
    lidar = dict(zip(lm_lidar._VIEWS, (T0, prior_inv, w_prior, edges,
                                       edge_mask, a, b, e_ok, edge_q,
                                       planars, planar_mask, n, d, p_ok,
                                       planar_q)))
    tensors = dict(zip(_VIS_VIEWS, (xyz, obs_uv, mask, w_lm, w_scale, P,
                                    T_cam_velo, T_vc, mask_nodepth, x1, x2)))
    o = _launch(lidar, tensors, iters, stage_iters, loss, consts, vconsts)
    return (o["out_T"], o["out_lam"], o["out_cost"], o["out_conv"],
            o["out_last"], o["out_nacc"])


@_batched.register_fake
def _(T0, *rest, **kw):
    b = T0.shape[0]
    return (T0.new_empty((b, 4, 4)), T0.new_empty((b,)), T0.new_empty((b,)),
            T0.new_empty((b,), dtype=torch.bool), T0.new_empty((b,)),
            T0.new_empty((b,), dtype=torch.int32))


_build.register_vmap(_batched)


def _vconsts(cfg, prep: Prepared) -> list[float]:
    return [prep.vis_weight, float(cfg.epi_weight),
            float(cfg.huber_delta_repr)]


def _inputs(T0, prior_inv, w_prior, edges, edge_mask, a, b, e_ok, planars,
            planar_mask, n, d, p_ok, prep: Prepared, edge_q, planar_q):
    """The operator's tensor arguments with a batch axis of 1."""
    lidar = (T0, prior_inv, w_prior, edges, edge_mask, a, b, e_ok, edge_q,
             planars, planar_mask, n, d, p_ok, planar_q)
    return tuple(None if x is None else x[None] for x in (*lidar, *prep[:-1]))


def lm_joint(T0, prior_inv, w_prior, edges, edge_mask, a, b, e_ok, planars,
             planar_mask, n, d, p_ok, vis, cfg, edge_q=None, planar_q=None,
             prepared: Prepared | None = None) -> lm.LMState:
    """The staged LM solve of the joint system at fixed correspondences.

    Args:
      T0 ... p_ok, edge_q, planar_q: as ``lm_lidar.lm_lidar``.
      vis: the ``icp.VisData`` of the solve.
      cfg: the ``SolverConfig``.
      prepared: ``prepare(vis, cfg)``, where a caller solves several times
        with the same ``vis``; else made here.

    Returns the final ``lm.LMState`` of one launch, counted as
    ``kernel.lm_joint`` in ``profiling.counters()``.  The tensors must be
    on the card (else ``ValueError``).
    """
    _KERNEL.require_cuda(T0)
    prep = prepare(vis, cfg) if prepared is None else prepared
    outs = _batched(*_inputs(T0, prior_inv, w_prior, edges, edge_mask, a, b,
                             e_ok, planars, planar_mask, n, d, p_ok, prep,
                             edge_q, planar_q),
                    cfg.lm_iters, cfg.prior_obs_stage_iters, cfg.icp_loss,
                    lm_lidar._consts(cfg), _vconsts(cfg, prep))
    return lm.LMState(*(o[0] for o in outs))


def lm_joint_reference(T0, prior_inv, w_prior, edges, edge_mask, a, b, e_ok,
                       planars, planar_mask, n, d, p_ok, vis, cfg,
                       edge_q=None, planar_q=None) -> lm.LMState:
    """The plain version of :func:`lm_joint`, on any device: ``lm_solve``
    on ``icp.make_lidar_system(..., vis=vis)``'s prior-less build with the
    staged prior."""
    from velo_tpu_torch.solve import icp

    build = icp.make_lidar_system(edges, edge_mask, a, b, e_ok, planars,
                                  planar_mask, n, d, p_ok, cfg, vis=vis,
                                  edge_q=edge_q, planar_q=planar_q)
    stage = icp.obs_stage(cfg, w_prior, prior_inv, build)
    return lm.lm_solve(None, T0, cfg, stage=stage)[1]


def joint_system(T, edges, edge_mask, a, b, e_ok, planars, planar_mask, n, d,
                 p_ok, vis, cfg, edge_q=None, planar_q=None):
    """The kernel's joint build alone at T -> (H (6, 6), g (6,), cost), as
    ``icp.make_lidar_system(..., vis=vis)(T)`` computes it without a
    prior: one launch (CUDA tensors only), for the card tests."""
    prep = prepare(vis, cfg)
    unused = torch.zeros(6, dtype=T.dtype, device=T.device)
    xs = _inputs(T, T, unused, edges, edge_mask, a, b, e_ok, planars,
                 planar_mask, n, d, p_ok, prep, edge_q, planar_q)
    lidar = dict(zip(lm_lidar._VIEWS, xs[:_N_LIDAR]))
    tensors = dict(zip(_VIS_VIEWS, xs[_N_LIDAR:]))
    s = _launch(lidar, tensors, cfg.lm_iters, cfg.prior_obs_stage_iters,
                cfg.icp_loss, lm_lidar._consts(cfg), _vconsts(cfg, prep),
                mode=1)["out_sys"][0]
    return s[:36].view(6, 6), s[36:42], s[42]
