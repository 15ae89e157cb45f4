"""The one-launch LM solve of the joint LiDAR-visual system
(``kernels/lm_joint.py``, ``csrc/lm_joint.cu``)
against the plain ``lm_solve`` over ``icp.make_lidar_system(..., vis=)``.

On the CPU:

* the kernel's source built for the host (g++, ``lm_joint_host``) against
  the plain joint solve on every joint solve of a small fused drive (the
  route forced on the CPU: 6 joint and 3 LiDAR solves a frame), the state
  and the build alone bitwise, and on the edge cases: no depth tracks, no
  tracks (frame 0), ``w_scale`` 0, fractional and a Python number,
  ``epi_weight`` 0, no ``uv_prev``, a baseline under ``min_baseline``,
  tracks behind the camera, ``w_lm`` a Python number;
* the pose-free inputs (``prepare``) are the plain path's own;
* the arguments' checks, and the entry points refuse CPU tensors (the
  plain version is ``lm_joint_reference``).

On the card (``cuda``): every joint solve of the benchmark drive's first
18 fused frames, kernel against the plain solve on the card; a batch of
four under ``vmap`` against four launches; the edge cases; a captured
graph replayed twice.

The file imports no JAX: ``python -m pytest --noconftest -q -m cuda
tests/test_torch_lm_joint.py`` runs the card tests where JAX is missing.
"""
import contextlib
import ctypes
import dataclasses
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

from benchmarks import harness
from test_torch_lm_lidar import _pose_gap, _same_state, _ulps
from velo_tpu_torch import config
from velo_tpu_torch.evaluation import profiling
from velo_tpu_torch.geom import camera, se3
from velo_tpu_torch.io import fixtures
from velo_tpu_torch.kernels import lm_joint, lm_lidar
from velo_tpu_torch.lidar import rangeimage
from velo_tpu_torch.pipeline import odometry
from velo_tpu_torch.solve import icp, lm
from velo_tpu_torch.solve import residuals as res


def _launches() -> int:
    """The lm_joint kernel's launches so far in this process."""
    return profiling.counters().get("kernel.lm_joint", (0, 0.0))[0]


ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "velo_tpu_torch" / "csrc" / "lm_joint.cu"
CARD_FRAMES = 18  # the benchmark's compare_frames
CARD_SEED = 2_147_483_659  # above 32 signed bits, as benchmark seeds may be
CPU_FRAMES = 4
STATE = ("out_T", "out_lam", "out_cost", "out_conv", "out_last", "out_nacc")


class Solve(NamedTuple):
    """One joint solve's inputs: ``lm_joint``'s positional tensors, its
    ``VisData``, its solver configuration and its quality weights."""
    args: tuple  # T0, prior_inv, w_prior, edges ... p_ok
    vis: icp.VisData
    cfg: object
    q: dict


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


@contextlib.contextmanager
def recording(force=False):
    """Record every solve ``icp._solve`` routes to ``lm_joint`` (and count
    those routed to ``lm_lidar``); with ``force`` the route is taken on the
    CPU too and each routed solve runs its plain version."""
    joint, lidar = [], []
    real_j, real_l, route = lm_joint.lm_joint, lm_lidar.lm_lidar, \
        icp._kernel_route

    def record(*args, prepared=None, **kw):
        joint.append(Solve(tuple(x.clone() for x in args[:13]),
                           icp.VisData(*(_clone(x) for x in args[13])),
                           args[14], {k: v.clone() for k, v in kw.items()
                                      if v is not None}))
        if force:
            return lm_joint.lm_joint_reference(*args, **kw)
        return real_j(*args, prepared=prepared, **kw)

    def count(*args, **kw):
        lidar.append(1)
        return (lm_lidar.lm_lidar_reference if force else real_l)(*args,
                                                                   **kw)

    lm_joint.lm_joint, lm_lidar.lm_lidar = record, count
    if force:
        icp._kernel_route = lambda cfg, prior_T, vis, device: route(
            cfg, prior_T, vis, torch.device("cuda"))
    try:
        yield joint, lidar
    finally:
        lm_joint.lm_joint, lm_lidar.lm_lidar = real_j, real_l
        icp._kernel_route = route


def _run_steps(cfg, grids, masks, images, cam, device):
    carry = odometry.init_carry(cfg, device)
    for i in range(len(grids)):
        carry, _ = odometry.step(carry, grids[i], masks[i], cfg, cam=cam,
                                 image=images[i])


@pytest.fixture(scope="module")
def cpu_solves():
    """Every joint solve of a fused 32 x 1024 drive of 4 sweeps with 128 x
    384 images, recorded through the kernels' route forced on the CPU."""
    base = config.tiny_test_config()
    cfg = dataclasses.replace(base, use_vision=True, prebin_host=True)
    fx = fixtures.make_fixture(n_frames=CPU_FRAMES,
                               n_rings=cfg.lidar.n_rings,
                               n_azimuth=cfg.lidar.n_azimuth,
                               height=cfg.vision.height,
                               width=cfg.vision.width)
    binned = [rangeimage.bin_scan_host(s, cfg.lidar) for s in fx.scans]
    grids = torch.from_numpy(np.stack([g for g, _ in binned]))
    masks = torch.from_numpy(np.stack([m for _, m in binned]))
    images = torch.from_numpy(np.stack(fx.images).astype(np.float32))
    cam = camera.from_numpy(fx.P, fx.T_cam_velo, cfg.vision.width,
                            cfg.vision.height, device="cpu")
    with recording(force=True) as (joint, lidar):
        _run_steps(cfg, grids, masks, images, cam, "cpu")
    return joint, len(lidar)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """``csrc/lm_joint.cu`` built for the host: ``lm_joint_host``."""
    out = tmp_path_factory.mktemp("lm_joint") / "liblm_joint_host.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2",
                    "-ffp-contract=off", "-shared", "-fPIC", "-o", str(out),
                    str(SRC)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.lm_joint_host.argtypes = [ctypes.POINTER(lm_lidar.Args),
                                  ctypes.POINTER(lm_joint.VisArgs)]
    return lib


def _batched(s: Solve, T=None):
    """(LiDAR tensors, visual tensors, vconsts) with a batch axis of 1, as
    the operator passes them; ``T`` in place of T0 and the prior's slots
    (the build alone)."""
    prep = lm_joint.prepare(s.vis, s.cfg)
    args = s.args if T is None else (T, T, torch.zeros(6), *s.args[3:])
    xs = lm_joint._inputs(*args, prep, s.q.get("edge_q"),
                          s.q.get("planar_q"))
    n = len(lm_lidar._VIEWS)
    return (dict(zip(lm_lidar._VIEWS, xs[:n])),
            dict(zip(lm_joint._VIS_VIEWS, xs[n:])),
            lm_joint._vconsts(s.cfg, prep))


def _host(lib, s: Solve, mode=0):
    """The host build's solve (mode 0), or its joint build alone at T0
    (mode 1)."""
    lidar, vis, vconsts = _batched(s, T=s.args[0] if mode else None)
    outs = lm_lidar._outputs(1, "cpu", mode)
    c = s.cfg
    a = lm_lidar.args(lidar, outs, c.lm_iters, c.prior_obs_stage_iters,
                      c.icp_loss, lm_lidar._consts(c), mode)
    v = lm_joint.vis_args(lidar, vis, vconsts)
    assert lib.lm_joint_host(ctypes.byref(a), ctypes.byref(v)) == 0
    if mode == 1:
        return outs["out_sys"][0]
    return lm.LMState(*(outs[k][0] for k in STATE))


def _plain(s: Solve):
    return lm_joint.lm_joint_reference(*s.args, s.vis, s.cfg, **s.q)


def _plain_system(s: Solve):
    H, g, c = icp.make_lidar_system(*s.args[3:], s.cfg, vis=s.vis,
                                    **s.q)(s.args[0])
    return torch.cat([H.reshape(-1), g, c[None]])


def _kernel(s: Solve):
    return lm_joint.lm_joint(*s.args, s.vis, s.cfg, **s.q)


def _to(s: Solve, device) -> Solve:
    return Solve(tuple(x.to(device) for x in s.args),
                 icp.VisData(*(x.to(device) if isinstance(x, torch.Tensor)
                               else x for x in s.vis)),
                 s.cfg, {k: v.to(device) for k, v in s.q.items()})


# ------------------------------------------------------------- edge cases

def _richest(solves) -> Solve:
    """The recorded solve with the most depth tracks, then tracks without
    depth, and a full reprojection weight."""
    return max(solves, key=lambda s: (float(s.vis.w_scale) >= 1.0,
                                      int(s.vis.mask.sum()),
                                      int(s.vis.mask_nodepth.sum())))


def _edge_case(name, solves) -> Solve:
    s = _richest(solves)
    vis = s.vis
    if name == "no_depth_tracks":
        vis = vis._replace(mask=torch.zeros_like(vis.mask))
    elif name == "no_tracks":  # frame 0: nothing tracked
        return next(x for x in solves if not bool(x.vis.mask.any())
                    and not bool(x.vis.mask_nodepth.any()))
    elif name == "w_scale_0":
        vis = vis._replace(w_scale=torch.zeros_like(vis.w_scale))
    elif name == "w_scale_fractional":
        vis = vis._replace(w_scale=torch.full_like(vis.w_scale, 0.375))
    elif name == "w_scale_number":
        vis = vis._replace(w_scale=0.3, w_lm=0.7)
    elif name == "epi_weight_0":
        return s._replace(cfg=dataclasses.replace(s.cfg, epi_weight=0.0))
    elif name == "no_uv_prev":
        vis = vis._replace(uv_prev=None, mask_nodepth=None)
    elif name == "short_baseline":
        # T0 at the camera's rest: M = I, |t| = 0 < min_baseline.
        return s._replace(args=(torch.eye(4), *s.args[1:]))
    elif name == "behind_camera":
        # Every other depth landmark mirrored through the sensor: z < 0.
        flip = torch.arange(vis.mask.shape[0]) % 2 == 0
        vis = vis._replace(xyz_prev_velo=torch.where(
            flip[:, None], -vis.xyz_prev_velo, vis.xyz_prev_velo))
    else:
        raise KeyError(name)
    return s._replace(vis=vis)


EDGE_CASES = ["no_depth_tracks", "no_tracks", "w_scale_0",
              "w_scale_fractional", "w_scale_number", "epi_weight_0",
              "no_uv_prev", "short_baseline", "behind_camera"]


def _expect_edge_case(name, s: Solve):
    """What the edge case sets up, checked on the plain path's pieces."""
    vis, T0 = s.vis, s.args[0]
    if name == "short_baseline":
        M = se3.compose(se3.compose(vis.T_cam_velo, se3.inv(T0)),
                        se3.inv(vis.T_cam_velo))
        _, ok = res.epipolar(M, vis.P[:3, :3], vis.uv_prev, vis.obs_uv,
                             vis.mask_nodepth)
        assert bool(vis.mask_nodepth.any()) and not bool(ok.any())
    if name == "behind_camera":
        Xc = se3.apply(vis.T_cam_velo,
                       se3.apply(se3.inv(T0), vis.xyz_prev_velo))
        _, _, ok = res.reprojection(Xc, vis.P, vis.obs_uv, vis.mask)
        assert bool((vis.mask & ~ok).any())


# ---------------------------------------------------------------- CPU tests

def test_forced_route_takes_6_joint_and_3_lidar_solves_a_frame(cpu_solves):
    joint, n_lidar = cpu_solves
    assert (len(joint), n_lidar) == (6 * CPU_FRAMES, 3 * CPU_FRAMES)
    # The drive exercises both visual blocks, at a full and a partial
    # reprojection weight.
    assert any(bool(s.vis.mask.any()) and float(s.vis.w_scale) == 1.0
               for s in joint)
    assert any(0.0 < float(s.vis.w_scale) < 1.0 for s in joint)
    assert all(bool(s.vis.mask_nodepth.any()) for s in joint[6:])


def test_host_build_equals_the_plain_joint_solve(cpu_solves, host_lib):
    """The kernel's arithmetic, built for the host, against the plain
    joint solve on every joint solve of the drive: the state bitwise, and
    the joint build alone."""
    joint, _ = cpu_solves
    for s in joint:
        assert _same_state(_host(host_lib, s), _plain(s))
        d = _ulps(_host(host_lib, s, mode=1), _plain_system(s))
        assert int(d.max()) == 0, d


@pytest.mark.parametrize("name", EDGE_CASES)
def test_host_build_edge_cases(name, cpu_solves, host_lib):
    s = _edge_case(name, cpu_solves[0])
    _expect_edge_case(name, s)
    assert _same_state(_host(host_lib, s), _plain(s))
    assert int(_ulps(_host(host_lib, s, mode=1), _plain_system(s)).max()) == 0


def test_prepare_is_the_plain_paths_own(cpu_solves):
    """The pose-free inputs equal what ``residuals._epipolar64`` and
    ``se3.inv`` compute inside the plain path."""
    s = _richest(cpu_solves[0])
    prep = lm_joint.prepare(s.vis, s.cfg)
    x1, x2, *_ = res._epipolar64(torch.eye(4), s.vis.P[:3, :3],
                                 s.vis.uv_prev, s.vis.obs_uv)
    assert torch.equal(prep.x1, x1) and torch.equal(prep.x2, x2)
    assert torch.equal(prep.T_vc, se3.inv(s.vis.T_cam_velo))
    off = lm_joint.prepare(s.vis, dataclasses.replace(s.cfg, epi_weight=0.0))
    assert off.x1 is None and off.mask_nodepth is None


@pytest.mark.parametrize("bad", ["xyz_shape", "x1_dtype", "mask_dtype",
                                 "epipolar_half", "camera_device"])
def test_kernel_arguments_refuse_a_broken_contract(bad, cpu_solves):
    s = _richest(cpu_solves[0])
    lidar, vis, vconsts = _batched(s)
    if bad == "xyz_shape":
        vis["xyz"] = vis["xyz"][:, :-1]
    elif bad == "x1_dtype":
        vis["x1"] = vis["x1"].float()
    elif bad == "mask_dtype":
        vis["mask"] = vis["mask"].float()
    elif bad == "epipolar_half":
        vis["x2"] = None
    else:
        vis["P"] = vis["P"].to("meta")
    with pytest.raises(ValueError):
        lm_joint.vis_args(lidar, vis, vconsts)


@pytest.mark.parametrize("entry", ["lm_joint", "operator", "joint_system"])
def test_entry_points_refuse_cpu_tensors(entry, cpu_solves):
    """Nothing runs the kernel's entry points on the CPU: they raise before
    any launch, and the plain solve is ``lm_joint_reference``."""
    s = _richest(cpu_solves[0])
    n0 = _launches()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        if entry == "lm_joint":
            _kernel(s)
        elif entry == "operator":
            lidar, vis, vconsts = _batched(s)
            c = s.cfg
            lm_joint._batched(*lidar.values(), *vis.values(), c.lm_iters,
                              c.prior_obs_stage_iters, c.icp_loss,
                              lm_lidar._consts(c), vconsts)
        else:
            lm_joint.joint_system(s.args[0], *s.args[3:], s.vis, s.cfg,
                                  **s.q)
    assert _launches() == n0


# ---------------------------------------------------------------- card tests

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_solves():
    """Every solve routed to the joint kernel in the benchmark drive's
    first 18 fused frames, stepped eagerly on the card."""
    dev = _card()
    from benchmarks import drive as drive_mod

    spec = harness.benchmark()
    entry = next(c for c in spec["configs"]
                 if c["name"] == "kitti-hdl64-fused")
    conf = dict(harness.config_file(entry), sequence_frames=CARD_FRAMES)
    cfg = harness.build_config(config, conf["velo_config"])
    fx = drive_mod.simulate(conf, CARD_SEED, dev)
    binned = [rangeimage.bin_scan_host(s, cfg.lidar) for s in fx.scans]
    grids = torch.from_numpy(np.stack([g for g, _ in binned])).to(dev)
    masks = torch.from_numpy(np.stack([m for _, m in binned])).to(dev)
    images = torch.from_numpy(fx.images).to(dev)
    cam = camera.from_numpy(fx.P, fx.T_cam_velo, cfg.vision.width,
                            cfg.vision.height, device=dev)
    with recording() as (joint, lidar):
        _run_steps(cfg, grids, masks, images, cam, dev)
    assert (len(joint), len(lidar)) == (6 * CARD_FRAMES, 3 * CARD_FRAMES)
    return joint


@pytest.mark.cuda
def test_card_solves_match_the_plain_path(card_solves):
    """Each solve's joint build alone within 1 float32 ulp of
    ``make_lidar_system(..., vis=)``'s; the full solve: accepted steps and
    convergence equal, T bitwise equal or within 1e-6 m / 1e-5 rad."""
    sys_differ = sys_entries = t_differ = 0
    worst_t = worst_r = 0.0
    for s in card_solves:
        got = lm_joint.joint_system(s.args[0], *s.args[3:], s.vis, s.cfg,
                                    **s.q)
        full = torch.cat([got[0].reshape(-1), got[1], got[2][None]])
        d = _ulps(full, _plain_system(s))
        sys_differ += int((d > 0).sum())
        sys_entries += d.numel()
        assert int(d.max()) <= 1, d
        k, p = _kernel(s), _plain(s)
        assert int(k.n_accept) == int(p.n_accept)
        assert bool(k.converged) == bool(p.converged)
        if not torch.equal(k.T, p.T):
            t_differ += 1
            gt, gr = _pose_gap(k.T, p.T)
            worst_t, worst_r = max(worst_t, gt), max(worst_r, gr)
    msg = (f"{len(card_solves)} joint solves, build entries differing "
           f"{sys_differ}/{sys_entries} (each <= 1 ulp), T differing in "
           f"{t_differ} solves (worst {worst_t:.3g} m, {worst_r:.3g} rad)")
    print(msg)
    assert worst_t <= 1e-6 and worst_r <= 1e-5, msg


@pytest.mark.cuda
def test_card_vmap_batch_is_one_launch(card_solves):
    """B = 4 under ``torch.func.vmap``, the camera shared by the lanes (at
    batch stride 0): one launch, bitwise the four single launches."""
    group = [s for s in card_solves if bool(s.vis.mask.any())][-4:]
    cfg, keys = group[0].cfg, sorted(group[0].q)
    singles = [_kernel(s) for s in group]
    args = [torch.stack([s.args[i] for s in group]) for i in range(13)]
    qs = [torch.stack([s.q[k] for s in group]) for k in keys]
    shared = ("P", "T_cam_velo")
    fields = [f for f in icp.VisData._fields if f not in shared]
    vs = [torch.stack([getattr(s.vis, f) for s in group]) for f in fields]
    cam = {f: getattr(group[0].vis, f) for f in shared}
    n0 = _launches()

    def one(*xs):
        vis = icp.VisData(**dict(zip(fields, xs[13:13 + len(fields)])),
                          **cam)
        q = dict(zip(keys, xs[13 + len(fields):]))
        return tuple(lm_joint.lm_joint(*xs[:13], vis, cfg, **q))

    batched = torch.func.vmap(one)(*args, *vs, *qs)
    torch.cuda.synchronize()
    assert _launches() - n0 == 1
    for i, single in enumerate(singles):
        assert _same_state([b[i] for b in batched], single)


@pytest.mark.cuda
@pytest.mark.parametrize("name", EDGE_CASES)
def test_card_edge_cases(name, card_solves):
    dev = _card()
    s = _to(_edge_case(name, [_to(x, "cpu") for x in card_solves]), dev)
    _expect_edge_case(name, s)
    want, got = _plain(s), _kernel(s)
    assert int(got.n_accept) == int(want.n_accept)
    assert bool(got.converged) == bool(want.converged)
    if not torch.equal(got.T, want.T):
        gt, gr = _pose_gap(got.T, want.T)
        assert gt <= 1e-6 and gr <= 1e-5, (name, gt, gr)


@pytest.mark.cuda
def test_card_graph_replays_give_the_same_bits(card_solves):
    s = _richest(card_solves)
    eager = _kernel(s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _kernel(s)
    graph.replay()
    first = [x.clone() for x in out]
    graph.replay()
    torch.cuda.synchronize()
    assert _same_state(first, out) and _same_state(out, eager)
