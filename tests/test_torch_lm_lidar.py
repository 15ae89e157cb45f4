"""The one-launch LM solve of the LiDAR system (``kernels/lm_lidar.py``,
``csrc/lm_lidar.cu``) against the plain ``lm_solve``.

On the CPU:

* the route: which solves ``icp._solve`` sends to a kernel
  (``icp._kernel_route``: ``lm_lidar``, or ``lm_joint`` with ``vis``, not
  under ``ct_sweep``), and the ``lm.kernel`` / ``lm.plain`` counters after
  one eager step (and with ``ct_sweep``);
* the kernel's source built for the host (g++, ``lm_lidar_host``: the same
  arithmetic with the sums in another order) against the plain solve on
  every LM solve of a small drive, Huber and Cauchy, its LiDAR build alone
  against ``make_lidar_system``, and on the edge cases;
* the entry points refuse CPU tensors (the plain version is
  ``lm_lidar_reference``);
* the benchmark's reader ``lm.kernel_share.replay``.

On the card (``cuda``): every routed LM solve of the benchmark drive's
first 18 frames, LiDAR and fused (map and scan-to-scan solves), kernel
against the plain solve on the card; a batch of four under ``vmap``
against four launches; the edge cases; a captured graph replayed twice.

The file imports no JAX: ``python -m pytest --noconftest -q -m cuda
tests/test_torch_lm_lidar.py`` runs the card tests where JAX is missing.
"""
import contextlib
import ctypes
import dataclasses
import subprocess
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import pytest
import torch

from benchmarks import harness
from velo_tpu_torch import config
from velo_tpu_torch.evaluation import profiling
from velo_tpu_torch.geom import se3
from velo_tpu_torch.io import fixtures
from velo_tpu_torch.kernels import lm_lidar
from velo_tpu_torch.lidar import rangeimage
from velo_tpu_torch.pipeline import odometry
from velo_tpu_torch.solve import icp, lm


def _launches() -> int:
    """The lm_lidar kernel's launches so far in this process."""
    return profiling.counters().get("kernel.lm_lidar", (0, 0.0))[0]


ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "velo_tpu_torch" / "csrc" / "lm_lidar.cu"
CARD_FRAMES = 18  # the benchmark's compare_frames
CARD_SEED = 2_147_483_659  # above 32 signed bits, as benchmark seeds may be


class Solve(NamedTuple):
    """One LM solve's inputs: ``lm_lidar``'s positional tensors, its
    solver configuration and its optional quality weights."""
    args: tuple  # T0, prior_inv, w_prior, edges ... p_ok
    cfg: object
    q: dict  # edge_q / planar_q where given


def _small_config(**solver):
    base = config.tiny_test_config()
    return dataclasses.replace(
        base, use_vision=False, prebin_host=True,
        lidar=dataclasses.replace(base.lidar, n_rings=16, n_azimuth=256),
        solver=dataclasses.replace(base.solver, **solver))


@contextlib.contextmanager
def recording(force=False):
    """Record every solve ``icp._solve`` routes to ``lm_lidar``; with
    ``force`` the route is taken on the CPU too, and each routed solve runs
    as ``lm_lidar_reference``, the plain solve."""
    solves = []
    real, route = lm_lidar.lm_lidar, icp._kernel_route
    solve = lm_lidar.lm_lidar_reference if force else real

    def record(*args, **kw):
        solves.append(Solve(tuple(x.clone() for x in args[:13]), args[13],
                            {k: v.clone() for k, v in kw.items()
                             if v is not None}))
        return solve(*args, **kw)

    lm_lidar.lm_lidar = record
    if force:
        icp._kernel_route = lambda cfg, prior_T, vis, device: route(
            cfg, prior_T, vis, torch.device("cuda"))
    try:
        yield solves
    finally:
        lm_lidar.lm_lidar, icp._kernel_route = real, route


def _run_steps(cfg, grids, masks, device, images=None, cam=None):
    carry = odometry.init_carry(cfg, device)
    for i in range(len(grids)):
        carry, _ = odometry.step(
            carry, grids[i], masks[i], cfg, cam=cam,
            image=None if images is None else images[i])


@pytest.fixture(scope="module", params=["huber", "cauchy"])
def cpu_solves(request):
    """Every LM solve of a 16 x 256 drive of 5 sweeps, recorded through the
    kernel's route forced on the CPU."""
    cfg = _small_config(icp_loss=request.param)
    fx = fixtures.make_fixture(n_frames=5, n_rings=16, n_azimuth=256,
                               with_images=False)
    binned = [rangeimage.bin_scan_host(s, cfg.lidar) for s in fx.scans]
    grids = torch.from_numpy(np.stack([g for g, _ in binned]))
    masks = torch.from_numpy(np.stack([m for _, m in binned]))
    with recording(force=True) as solves:
        _run_steps(cfg, grids, masks, "cpu")
    assert len(solves) == 5 * 9
    return request.param, solves


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """``csrc/lm_lidar.cu`` built for the host: ``lm_lidar_host``."""
    out = tmp_path_factory.mktemp("lm_lidar") / "liblm_lidar_host.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2",
                    "-ffp-contract=off", "-shared", "-fPIC", "-o", str(out),
                    str(SRC)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.lm_lidar_host.argtypes = [ctypes.POINTER(lm_lidar.Args)]
    return lib


def _tensors(s: Solve) -> dict:
    vals = dict(zip(("T0", "prior_inv", "w_prior", "edges", "edge_mask", "a",
                     "b", "e_ok", "planars", "planar_mask", "n", "d", "p_ok"),
                    s.args))
    vals.update(edge_q=s.q.get("edge_q"), planar_q=s.q.get("planar_q"))
    return {k: vals[k] for k in lm_lidar._VIEWS}


def _host(lib, s: Solve, mode=0) -> dict:
    """The host build's solve (mode 0), or its build alone at T0 (mode 1)
    from the inputs the card's ``lidar_system`` passes."""
    tensors = ({k: None if x is None else x[None]
                for k, x in _tensors(s).items()} if mode == 0 else
               lm_lidar.system_inputs(s.args[0], *s.args[3:], **s.q))
    outs = lm_lidar._outputs(1, "cpu", mode)
    c = s.cfg
    a = lm_lidar.args(tensors, outs, c.lm_iters, c.prior_obs_stage_iters,
                      c.icp_loss, lm_lidar._consts(c), mode)
    assert lib.lm_lidar_host(ctypes.byref(a)) == 0
    if mode == 1:
        return outs["out_sys"][0]
    return lm.LMState(*(outs[k][0] for k in (
        "out_T", "out_lam", "out_cost", "out_conv", "out_last", "out_nacc")))


def _plain(s: Solve):
    return lm_lidar.lm_lidar_reference(*s.args, s.cfg, **s.q)


def _plain_system(s: Solve):
    H, g, c = icp.make_lidar_system(*s.args[3:], s.cfg, **s.q)(s.args[0])
    return torch.cat([H.reshape(-1), g, c[None]])


def _kernel(s: Solve):
    return lm_lidar.lm_lidar(*s.args, s.cfg, **s.q)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Float32 ulps between a and b, elementwise."""
    ia = a.float().contiguous().view(torch.int32).long()
    ib = b.float().contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


def _pose_gap(Ta, Tb):
    """(translation gap m, rotation gap rad) between two poses."""
    D = se3.compose(se3.inv(Ta.double()), Tb.double())
    t = torch.linalg.norm(D[:3, 3]).item()
    c = ((torch.trace(D[:3, :3]) - 1.0) / 2.0).clamp(-1.0, 1.0)
    return t, torch.arccos(c).item()


def _same_state(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------- problems

def _problem(seed, n_edge=200, n_planar=400, offset=0.05, prior_scale=1.0,
             device="cpu", **solver):
    """A synthetic solve: planars on six random planes and edges along 40
    random lines, the current points those of the target moved by a pose
    ``offset`` from the identity; the motion prior at the identity."""
    rng = np.random.default_rng(seed)
    normals = rng.normal(size=(6, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    offsets = rng.uniform(-10, 10, 6)
    k = rng.integers(0, 6, n_planar)
    p = rng.uniform(-15, 15, (n_planar, 3))
    p -= (np.sum(p * normals[k], 1) + offsets[k])[:, None] * normals[k]
    starts = rng.uniform(-15, 15, (40, 3))
    dirs = rng.normal(size=(40, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    j = rng.integers(0, 40, n_edge)
    e = starts[j] + rng.uniform(-3, 3, (n_edge, 1)) * dirs[j]
    xi = rng.normal(size=6) * offset
    xi[3:] *= 0.1
    cfg = dataclasses.replace(config.SolverConfig(), **solver)
    w, prior_inv = icp._prior_weights(
        cfg, torch.eye(4), torch.tensor(prior_scale, dtype=torch.float32))
    T_off = se3.exp(torch.tensor(xi, dtype=torch.float32))
    cur = se3.inv(T_off)  # current points: the target's moved by T_off^-1

    def f32(x):
        return torch.tensor(x, dtype=torch.float32)

    edges = se3.apply(cur, f32(e))
    planars = se3.apply(cur, f32(p))
    on = torch.ones(n_edge, dtype=torch.bool)
    pon = torch.ones(n_planar, dtype=torch.bool)
    args = (torch.eye(4), prior_inv, w, edges, on, f32(starts[j]),
            f32(starts[j] + 0.2 * dirs[j]), on.clone(), planars, pon,
            f32(normals[k]), f32(offsets[k]), pon.clone())
    q = {"edge_q": f32(rng.uniform(0.5, 1.0, n_edge)),
         "planar_q": f32(rng.uniform(0.5, 1.0, n_planar))}
    s = Solve(args, cfg, q)
    return _to(s, device)


def _to(s: Solve, device) -> Solve:
    return Solve(tuple(x.to(device) for x in s.args), s.cfg,
                 {k: v.to(device) for k, v in s.q.items()})


def _edge_case(name, device="cpu") -> Solve:
    if name == "masks_off":  # fewer than _MIN_CORR correspondences
        s = _problem(11)
        a = list(s.args)
        for i in (4, 7, 9, 12):
            a[i] = torch.zeros_like(a[i])
        return _to(Solve(tuple(a), s.cfg, s.q), device)
    if name == "not_pd":  # negative weights: H negative definite, `bad`
        s = _problem(12, prior_scale=0.0)
        return _to(Solve(s.args, s.cfg, {"edge_q": -s.q["edge_q"],
                                         "planar_q": -s.q["planar_q"]}),
                   device)
    if name == "prior_scale_0":  # frames 0-1: the prior's weights are 0
        return _problem(13, prior_scale=0.0, device=device)
    if name == "converge_first":  # the first step is below converge_tol
        return _problem(14, offset=2e-6, device=device)
    if name == "cauchy":
        return _problem(15, icp_loss="cauchy", device=device)
    raise KeyError(name)


EDGE_CASES = ["masks_off", "not_pd", "prior_scale_0", "converge_first",
              "cauchy"]


def _expect_edge_case(name, st):
    """What the plain solve does on each edge case."""
    if name == "not_pd":
        assert int(st.n_accept) == 0 and torch.equal(st.T, torch.eye(4).to(
            st.T.device))
    if name == "converge_first":
        assert bool(st.converged) and int(st.n_accept) == 1
    if name in ("prior_scale_0", "cauchy"):
        assert int(st.n_accept) >= 2


# ---------------------------------------------------------------- CPU tests

def _cfg(**solver):
    return SimpleNamespace(**{**dataclasses.asdict(config.SolverConfig()),
                              **solver})


ROUTES = {
    "cuda_lidar": (_cfg(), True, None, "cuda", True),
    "vis": (_cfg(), True, object(), "cuda", True),
    "ct_sweep_vis": (_cfg(ct_sweep=True), True, object(), "cuda", False),
    "ct_sweep_lidar": (_cfg(ct_sweep=True), True, None, "cuda", True),
    "deferred_tail": (_cfg(prior_obs_impl="deferred_tail"), True, None,
                      "cuda", False),
    "deferred": (_cfg(prior_obs_impl="deferred"), True, None, "cuda", False),
    "degen_rel_min": (_cfg(degen_rel_min=0.05), True, None, "cuda", False),
    "no_prior": (_cfg(), False, None, "cuda", False),
    "obs_gain_0": (_cfg(prior_obs_gain=0.0), True, None, "cuda", False),
    "cpu": (_cfg(), True, None, "cpu", False),
    "cauchy": (_cfg(icp_loss="cauchy"), True, None, "cuda", True),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route(case):
    cfg, prior, vis, dev, want = ROUTES[case]
    prior_T = torch.eye(4) if prior else None
    assert icp._kernel_route(cfg, prior_T, vis, torch.device(dev)) is want


def _counts():
    c = profiling.counters()
    return (c.get("lm.kernel", (0, 0.0))[0], c.get("lm.plain", (0, 0.0))[0])


@pytest.mark.parametrize("ct_sweep", [False, True])
def test_counters_of_one_eager_cpu_step(ct_sweep):
    """The cells' settings: 3 map solves and 5 + 1 scan-to-scan solves a
    step, all on the plain path on the CPU; ct_sweep's 12-DoF scan-to-scan
    solve goes through neither route."""
    cfg = _small_config(ct_sweep=ct_sweep)
    fx = fixtures.make_fixture(n_frames=1, n_rings=16, n_azimuth=256,
                               with_images=False)
    g, m = rangeimage.bin_scan_host(fx.scans[0], cfg.lidar)
    k0, p0 = _counts()
    odometry.step(odometry.init_carry(cfg, "cpu"), torch.from_numpy(g),
                  torch.from_numpy(m), cfg)
    k1, p1 = _counts()
    assert (k1 - k0, p1 - p0) == (0, 3 if ct_sweep else 9)


def test_host_build_equals_the_plain_solve(cpu_solves, host_lib):
    """The kernel's arithmetic, built for the host, against the plain solve
    on every LM solve of the drive: the state bitwise, and the build alone;
    with Cauchy the costs within 1 ulp (log1pf is the host C library's, not
    PyTorch's)."""
    loss, solves = cpu_solves
    ulp = 0 if loss == "huber" else 1
    differ, worst = 0, 0
    for s in solves:
        got, want = _host(host_lib, s), _plain(s)
        assert _same_state(got._replace(cost=want.cost), want), (loss, got,
                                                                 want)
        assert int(_ulps(got.cost, want.cost)) <= ulp, (got.cost, want.cost)
        d = _ulps(_host(host_lib, s, mode=1), _plain_system(s))
        differ += int((d > 0).sum())
        worst = max(worst, int(d.max()))
    assert worst <= ulp, (differ, worst)


@pytest.mark.parametrize("name", EDGE_CASES)
def test_host_build_edge_cases(name, host_lib):
    s = _edge_case(name)
    want = _plain(s)
    _expect_edge_case(name, want)
    assert _same_state(_host(host_lib, s), want)


@pytest.mark.parametrize("bad", ["d_shape", "mask_dtype", "w_prior_shape"])
def test_kernel_arguments_refuse_a_broken_contract(bad):
    s = _problem(16)
    tensors = {k: None if x is None else x[None]
               for k, x in _tensors(s).items()}
    if bad == "d_shape":
        tensors["d"] = tensors["d"][:, :-1]
    elif bad == "mask_dtype":
        tensors["e_ok"] = tensors["e_ok"].float()
    else:
        tensors["w_prior"] = tensors["w_prior"][:, :3]
    with pytest.raises(ValueError):
        lm_lidar.args(tensors, lm_lidar._outputs(1, "cpu", 0), 4, 4, "huber",
                      lm_lidar._consts(s.cfg), 0)


@pytest.mark.parametrize("entry", ["lm_lidar", "operator", "lidar_system"])
def test_entry_points_refuse_cpu_tensors(entry):
    """Nothing runs the kernel's entry points on the CPU: they raise before
    any launch, and the plain solve is ``lm_lidar_reference``."""
    s = _problem(17)
    n0 = _launches()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        if entry == "lm_lidar":
            _kernel(s)
        elif entry == "operator":
            tensors = _tensors(s)
            lm_lidar._batched(
                *(None if x is None else x[None] for x in tensors.values()),
                s.cfg.lm_iters, s.cfg.prior_obs_stage_iters, s.cfg.icp_loss,
                lm_lidar._consts(s.cfg))
        else:
            lm_lidar.lidar_system(s.args[0], *s.args[3:], s.cfg, **s.q)
    assert _launches() == n0


def _reader():
    return harness.plugin("metrics", "lm.kernel_share.replay")


def test_kernel_share_reader(monkeypatch):
    read = _reader().read
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert read({"kind": "replay"}) is None
    monkeypatch.setattr(profiling, "counters", lambda: {
        "lm.kernel": (3, 0.0), "lm.plain": (6, 0.0)})
    assert read({"kind": "replay"}) == pytest.approx(1 / 3)
    assert read({"kind": "online"}) is None
    monkeypatch.setattr(profiling, "counters", lambda: {
        "lm.kernel": (9, 0.0)})
    assert read({"kind": "replay"}) == 1.0
    monkeypatch.delattr(profiling, "counters")
    assert read({"kind": "replay"}) is None


# ---------------------------------------------------------------- card tests

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["kitti-hdl64-lidar",
                                        "kitti-hdl64-fused"])
def card_solves(request):
    """Every solve routed to the kernel in the benchmark drive's first 18
    frames, stepped eagerly on the card."""
    dev = _card()
    from benchmarks import drive as drive_mod
    from velo_tpu_torch.geom import camera

    spec = harness.benchmark()
    entry = next(c for c in spec["configs"] if c["name"] == request.param)
    conf = dict(harness.config_file(entry), sequence_frames=CARD_FRAMES)
    cfg = harness.build_config(config, conf["velo_config"])
    fx = drive_mod.simulate(conf, CARD_SEED, dev)
    binned = [rangeimage.bin_scan_host(s, cfg.lidar) for s in fx.scans]
    grids = torch.from_numpy(np.stack([g for g, _ in binned])).to(dev)
    masks = torch.from_numpy(np.stack([m for _, m in binned])).to(dev)
    images = cam = None
    if cfg.use_vision:
        images = torch.from_numpy(fx.images).to(dev)
        cam = camera.from_numpy(fx.P, fx.T_cam_velo, cfg.vision.width,
                                cfg.vision.height, device=dev)
    with recording() as solves:
        _run_steps(cfg, grids, masks, dev, images=images, cam=cam)
    per_frame = 3 if cfg.use_vision else 9
    assert len(solves) == per_frame * CARD_FRAMES
    return request.param, solves


@pytest.mark.cuda
def test_card_solves_match_the_plain_path(card_solves):
    """Each solve's build alone within 1 float32 ulp of
    ``make_lidar_system``'s; the full solve: accepted steps and convergence
    equal, T bitwise equal or within 1e-6 m / 1e-5 rad."""
    name, solves = card_solves
    sys_differ = sys_entries = t_differ = 0
    worst_t = worst_r = 0.0
    for s in solves:
        got = lm_lidar.lidar_system(s.args[0], *s.args[3:], s.cfg, **s.q)
        full = torch.cat([got[0].reshape(-1), got[1], got[2][None]])
        d = _ulps(full, _plain_system(s))
        sys_differ += int((d > 0).sum())
        sys_entries += d.numel()
        assert int(d.max()) <= 1, (name, d)
        k, p = _kernel(s), _plain(s)
        assert int(k.n_accept) == int(p.n_accept)
        assert bool(k.converged) == bool(p.converged)
        if not torch.equal(k.T, p.T):
            t_differ += 1
            gt, gr = _pose_gap(k.T, p.T)
            worst_t, worst_r = max(worst_t, gt), max(worst_r, gr)
    msg = (f"{name}: {len(solves)} solves, build entries differing "
           f"{sys_differ}/{sys_entries} (each <= 1 ulp), T differing in "
           f"{t_differ} solves (worst {worst_t:.3g} m, {worst_r:.3g} rad)")
    print(msg)
    assert worst_t <= 1e-6 and worst_r <= 1e-5, msg


@pytest.mark.cuda
def test_card_vmap_batch_is_one_launch(card_solves):
    """B = 4 under ``torch.func.vmap``: one launch, bitwise the four single
    launches."""
    _, solves = card_solves
    group = [s for s in solves if set(s.q) == set(solves[0].q)][:4]
    cfg, keys = group[0].cfg, sorted(group[0].q)
    singles = [_kernel(s) for s in group]
    args = [torch.stack([s.args[i] for s in group]) for i in range(13)]
    qs = [torch.stack([s.q[k] for s in group]) for k in keys]
    n0 = _launches()
    batched = torch.func.vmap(lambda *xs: tuple(lm_lidar.lm_lidar(
        *xs[:13], cfg, **dict(zip(keys, xs[13:])))))(*args, *qs)
    torch.cuda.synchronize()
    assert _launches() - n0 == 1
    for i, single in enumerate(singles):
        assert _same_state([b[i] for b in batched], single)


@pytest.mark.cuda
@pytest.mark.parametrize("name", EDGE_CASES)
def test_card_edge_cases(name):
    s = _edge_case(name, _card())
    want = _plain(s)
    _expect_edge_case(name, want)
    got = _kernel(s)
    assert int(got.n_accept) == int(want.n_accept)
    assert bool(got.converged) == bool(want.converged)
    if not torch.equal(got.T, want.T):
        gt, gr = _pose_gap(got.T, want.T)
        assert gt <= 1e-6 and gr <= 1e-5, (name, gt, gr)


@pytest.mark.cuda
def test_card_graph_replays_give_the_same_bits():
    s = _problem(21, n_edge=1024, n_planar=2048, device=_card())
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

