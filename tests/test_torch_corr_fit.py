"""The one-launch correspondence fit (``kernels/corr_fit.py``,
``csrc/corr_fit.cu``) against the plain fit functions of ``solve/icp``.

On the CPU:

* the kernel's source built for the host (g++, ``corr_fit_host``) against
  the plain path, bitwise, on every fit of a 16 x 256 drive of 5 sweeps,
  dense and hash engine (the 2-point edge lines, the PCA lines and the
  planes), and on edge cases: flat ground (an exact-zero eigenvalue),
  collinear rows, identical rows (``p2 < 1e-20``), fewer than 3 valid
  rows, none valid, d^2 ties, and all rows on one ring;
* the route: the CPU runs the plain fit, counted as ``fit.plain``;
* the arguments refuse broken shapes and dtypes, and the entry points
  refuse CPU tensors;
* the benchmark's reader ``fit.kernel_share.replay``.

On the card (``cuda``): every fit of the benchmark drive's first frames,
LiDAR (dense) and hash, kernel against the plain version bitwise; a batch
of eight under ``vmap`` in one launch; a captured graph; the launches of
captured LiDAR steps.

The file imports no JAX: ``python -m pytest --noconftest -q -m cuda
tests/test_torch_corr_fit.py`` runs the card tests where JAX is missing.
"""
import collections
import ctypes
import dataclasses
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

from benchmarks import harness
from velo_tpu_torch import config
from velo_tpu_torch.evaluation import profiling
from velo_tpu_torch.io import fixtures
from velo_tpu_torch.kernels import corr_fit
from velo_tpu_torch.lidar import rangeimage
from velo_tpu_torch.pipeline import graphs, odometry

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "velo_tpu_torch" / "csrc" / "corr_fit.cu"
CARD_FRAMES = 6
CARD_SEED = 2_147_483_659  # above 32 signed bits, as benchmark seeds may be


class Call(NamedTuple):
    """One fit's inputs, as ``icp._fit`` passes them."""
    edge: corr_fit.Rows
    pe: torch.Tensor
    e_mask: torch.Tensor
    planar: corr_fit.Rows
    pp: torch.Tensor
    p_mask: torch.Tensor
    cfg: object
    line: bool

    def run(self, fn):
        return fn(*self[:6], self.cfg, line=self.line)


def _clone(x):
    if isinstance(x, corr_fit.Rows):
        return x._replace(pts=x.pts.clone(), payload=x.payload.clone(),
                          ok=x.ok.clone())
    return x.clone() if isinstance(x, torch.Tensor) else x


def _launches() -> int:
    return profiling.counters().get("kernel.corr_fit", (0, 0.0))[0]


def _counts():
    c = profiling.counters()
    return tuple(c.get(k, (0, 0.0))[0] for k in ("fit.kernel", "fit.plain",
                                                  "lm.plain"))


def _small_config(**solver):
    base = config.tiny_test_config()
    return dataclasses.replace(
        base, use_vision=False, prebin_host=True,
        lidar=dataclasses.replace(base.lidar, n_rings=16, n_azimuth=256),
        solver=dataclasses.replace(base.solver, **solver))


def _drive(n_frames, cfg):
    fx = fixtures.make_fixture(n_frames=n_frames, n_rings=16, n_azimuth=256,
                               with_images=False)
    binned = [rangeimage.bin_scan_host(s, cfg.lidar) for s in fx.scans]
    return (torch.from_numpy(np.stack([g for g, _ in binned])),
            torch.from_numpy(np.stack([m for _, m in binned])))


def _record(module_attr, calls):
    """Wrap ``corr_fit.<module_attr>`` to record each call's inputs."""
    real = getattr(corr_fit, module_attr)

    def record(*args, line=False):
        calls.append(Call(*(_clone(x) for x in args), line))
        return real(*args, line=line)

    return real, record


def _run_steps(cfg, grids, masks, device, attr):
    calls = []
    real, record = _record(attr, calls)
    setattr(corr_fit, attr, record)
    try:
        carry = odometry.init_carry(cfg, device)
        for i in range(len(grids)):
            carry, _ = odometry.step(carry, grids[i].to(device),
                                     masks[i].to(device), cfg)
    finally:
        setattr(corr_fit, attr, real)
    return calls


@pytest.fixture(scope="module", params=["dense", "hash"])
def cpu_fits(request):
    """Every fit of a 16 x 256 drive of 5 sweeps on the CPU."""
    cfg = _small_config(nn_engine=request.param)
    grids, masks = _drive(5, cfg)
    calls = _run_steps(cfg, grids, masks, "cpu", "corr_fit_reference")
    assert len(calls) == 5 * 9
    return request.param, calls


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """``csrc/corr_fit.cu`` built for the host: ``corr_fit_host``."""
    out = tmp_path_factory.mktemp("corr_fit") / "libcorr_fit_host.so"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2",
                    "-ffp-contract=off", "-shared", "-fPIC", "-o", str(out),
                    str(SRC)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.corr_fit_host.argtypes = [ctypes.POINTER(corr_fit.Args)]
    return lib


def _host(lib, call: Call) -> corr_fit.Fit:
    a, outs = corr_fit.args(*corr_fit.inputs(*call[:6], call.cfg, call.line))
    assert lib.corr_fit_host(ctypes.byref(a)) == 0
    return corr_fit.fit_of(outs, call.line)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32) if x.is_floating_point() else x


def _differs(got: corr_fit.Fit, want: corr_fit.Fit) -> list:
    """The fields of two fits that are not bitwise equal."""
    bad = []
    for name, g, w in zip(corr_fit.Fit._fields, got, want):
        if (g is None) != (w is None) or (
                g is not None and not torch.equal(_bits(g), _bits(w))):
            bad.append(name)
    return bad


# ---------------------------------------------------------------- CPU tests

def test_host_build_equals_the_plain_path(cpu_fits, host_lib):
    """Every fit of the drive: all eight outputs bitwise, in each of the
    three modes (2-point and PCA lines, planes)."""
    engine, calls = cpu_fits
    modes = collections.Counter(c.line for c in calls)
    assert modes[True] == 5 * 3 and modes[False] == 5 * 6
    assert {c.edge.rerank for c in calls} == {engine == "dense"}
    fitted = 0  # fits with both gates open somewhere (frame 0 has none)
    for i, call in enumerate(calls):
        want = call.run(corr_fit.corr_fit_reference)
        fitted += bool(want.p_ok.any()) and bool(want.e_ok.any())
        assert _differs(_host(host_lib, call), want) == [], (engine, i)
    assert fitted >= 4 * 9


def _rows(pts, ring, ok, k, rerank):
    f32 = torch.float32
    return corr_fit.Rows(torch.as_tensor(pts, dtype=f32),
                         torch.as_tensor(ring, dtype=torch.int32)[..., None],
                         torch.as_tensor(ok, dtype=torch.bool), k, rerank)


def _edge_case(name, rerank, line) -> Call:
    """Q = 6 queries near the origin, each with C = 16 candidates (re-ranked)
    or k = 5 rows (as given), arranged for the case; edges and planars
    share the rows."""
    rng = np.random.default_rng(["flat", "collinear", "iso", "few_valid",
                                 "none_valid", "ties", "one_ring"].index(name))
    q, c = 6, 16 if rerank else 5
    p = rng.uniform(-0.2, 0.2, (q, 3))
    pts = p[:, None, :] + rng.uniform(-0.5, 0.5, (q, c, 3))
    ring = rng.integers(0, 4, (q, c))
    ok = np.ones((q, c), bool)
    mask = np.ones(q, bool)
    if name == "flat":  # rows on z = 0 on a grid: an exact-zero eigenvalue
        pts[..., 2] = 0.0
        pts[..., :2] = np.round(pts[..., :2] * 8) / 8
        p[:, 2] = 0.0
    elif name == "collinear":  # rows on the x axis: two zero eigenvalues
        pts[..., 1:] = 0.0
        pts[..., 0] = np.round(pts[..., 0] * 16) / 16
    elif name == "iso":  # identical rows: the covariance is 0, p2 < 1e-20
        pts[:] = np.round(p[:, None, :] * 4) / 4
    elif name == "few_valid":  # 2 valid rows, then none (query 5 masked)
        ok[:, 2:] = False
        mask[5] = False
    elif name == "none_valid":
        ok[:] = False
    elif name == "ties":  # equal d^2 at mirrored offsets
        p[:] = 0.0
        offs = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                         [0, 0, 1], [0, 0, -1]], float) * 0.5
        pts[:] = offs[np.arange(c) % 6] * (1 + (np.arange(c) // 6))[:, None]
        ring = np.arange(q * c).reshape(q, c) % 3
    elif name == "one_ring":  # the 2-point rule finds no second ring
        ring[:] = 7
    cfg = config.SolverConfig()
    k = 5
    rows = _rows(pts, ring, ok, k, rerank)
    f32 = torch.float32
    return Call(rows, torch.as_tensor(p, dtype=f32), torch.as_tensor(mask),
                rows, torch.as_tensor(p, dtype=f32), torch.as_tensor(mask),
                cfg, line)


EDGE_CASES = ["flat", "collinear", "iso", "few_valid", "none_valid", "ties",
              "one_ring"]


def _expect_edge_case(name, call, fit):
    """What the plain path does on each case."""
    if name == "flat":
        assert bool(fit.p_ok.all()) and bool((fit.n[:, 2].abs() == 1).all())
    if name == "collinear" and call.line:
        assert bool(fit.e_ok.all())
    if name in ("iso", "few_valid", "none_valid"):
        assert not bool(fit.p_ok.any())
    if name == "iso" and call.line:
        assert not bool(fit.e_ok.any())
    if name in ("none_valid", "one_ring") and not call.line:
        assert not bool(fit.e_ok.any())
    if name == "ties" and call.edge.rerank and not call.line:
        # The nearest of the tied first six: the lowest index.
        assert torch.equal(fit.a[0], call.edge.pts[0, 0])


@pytest.mark.parametrize("line", [False, True], ids=["2pt", "line"])
@pytest.mark.parametrize("rerank", [True, False], ids=["dense", "hash"])
@pytest.mark.parametrize("name", EDGE_CASES)
def test_host_build_edge_cases(name, rerank, line, host_lib):
    call = _edge_case(name, rerank, line)
    want = call.run(corr_fit.corr_fit_reference)
    _expect_edge_case(name, call, want)
    assert _differs(_host(host_lib, call), want) == []


@pytest.mark.parametrize("variant", ["dense", "hash", "ct_sweep"])
def test_route_runs_the_plain_fit_on_the_cpu(variant):
    """One eager CPU step: each outer iteration's fit is plain
    (``fit.plain``), none launches; one fit per LM solve of ``_solve``,
    plus ct_sweep's own scan-to-scan iterations."""
    solver = ({"ct_sweep": True} if variant == "ct_sweep"
              else {"nn_engine": variant})
    cfg = _small_config(**solver)
    grids, masks = _drive(1, cfg)
    k0, p0, lm0 = _counts()
    n0 = _launches()
    odometry.step(odometry.init_carry(cfg, "cpu"), grids[0], masks[0], cfg)
    k1, p1, lm1 = _counts()
    extra = cfg.solver.icp_iters_odom if variant == "ct_sweep" else 0
    assert (k1 - k0, p1 - p0) == (0, lm1 - lm0 + extra)
    assert p1 - p0 == 9 - (1 if variant == "ct_sweep" else 0)
    assert _launches() == n0


def _call() -> Call:
    return _edge_case("ties", rerank=True, line=False)


@pytest.mark.parametrize("bad", ["pts_dtype", "ok_shape", "mask_dtype",
                                 "no_ring", "k_above_rows", "k_above_kernel",
                                 "batches_differ"])
def test_arguments_refuse_a_broken_contract(bad):
    args = list(corr_fit.inputs(*_call()[:6], config.SolverConfig()))
    names = ("e_pts", "e_ring", "e_ok", "e_p", "e_mask", "p_pts", "p_ok",
             "p_p", "p_mask", "line", "k_edge", "k_planar", "rerank", "r2")
    at = {n: i for i, n in enumerate(names)}
    if bad == "pts_dtype":
        args[at["e_pts"]] = args[at["e_pts"]].double()
    elif bad == "ok_shape":
        args[at["p_ok"]] = args[at["p_ok"]][:, :, :-1]
    elif bad == "mask_dtype":
        args[at["e_mask"]] = args[at["e_mask"]].float()
    elif bad == "no_ring":
        args[at["e_ring"]] = None
    elif bad == "k_above_rows":
        args[at["k_planar"]] = 17
    elif bad == "k_above_kernel":
        args[at["p_pts"]] = torch.zeros(1, 6, 40, 3)
        args[at["p_ok"]] = torch.ones(1, 6, 40, dtype=torch.bool)
        args[at["k_planar"]] = 20
    else:
        args[at["p_p"]] = args[at["p_p"]].expand(2, -1, -1)
    with pytest.raises(ValueError, match="corr_fit"):
        corr_fit.args(*args)


@pytest.mark.parametrize("entry", ["corr_fit", "operator"])
def test_entry_points_refuse_cpu_tensors(entry):
    """Nothing runs the kernel's entry points on the CPU: they raise before
    any launch, and the plain version is ``corr_fit_reference``."""
    call = _call()
    n0 = _launches()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        if entry == "corr_fit":
            call.run(corr_fit.corr_fit)
        else:
            corr_fit._batched(*corr_fit.inputs(*call[:6], call.cfg))
    assert _launches() == n0


def test_kernel_share_reader(monkeypatch):
    read = harness.plugin("metrics", "fit.kernel_share.replay").read
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert read({"kind": "replay"}) is None
    monkeypatch.setattr(profiling, "counters", lambda: {
        "fit.kernel": (6, 0.0), "fit.plain": (3, 0.0)})
    assert read({"kind": "replay"}) == pytest.approx(2 / 3)
    assert read({"kind": "online"}) is None
    monkeypatch.setattr(profiling, "counters", lambda: {
        "fit.kernel": (9, 0.0), "lm.plain": (9, 0.0)})
    assert read({"kind": "replay"}) == 1.0
    monkeypatch.delattr(profiling, "counters")
    assert read({"kind": "replay"}) is None


# ---------------------------------------------------------------- card tests

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["kitti-hdl64-lidar",
                                        "kitti-hdl64-lidar-hash"])
def card_fits(request):
    """Every fit of the benchmark drive's first CARD_FRAMES frames, stepped
    eagerly on the card: 1024 edges and 2048 planars, C = 16, k = 5."""
    dev = _card()
    from benchmarks import drive as drive_mod

    spec = harness.benchmark()
    entry = next(c for c in spec["configs"] if c["name"] == request.param)
    conf = dict(harness.config_file(entry), sequence_frames=CARD_FRAMES)
    cfg = harness.build_config(config, conf["velo_config"])
    fx = drive_mod.simulate(conf, CARD_SEED, dev)
    binned = [rangeimage.bin_scan_host(s, cfg.lidar) for s in fx.scans]
    grids = torch.from_numpy(np.stack([g for g, _ in binned]))
    masks = torch.from_numpy(np.stack([m for _, m in binned]))
    n0 = _launches()
    calls = _run_steps(cfg, grids, masks, dev, "corr_fit")
    assert len(calls) == 9 * CARD_FRAMES == _launches() - n0
    return request.param, calls


@pytest.mark.cuda
def test_card_fits_match_the_plain_path(card_fits):
    name, calls = card_fits
    assert calls[0].pe.shape == (1024, 3) and calls[0].pp.shape == (2048, 3)
    for i, call in enumerate(calls):
        got = call.run(corr_fit.corr_fit)
        want = call.run(corr_fit.corr_fit_reference)
        assert _differs(got, want) == [], (name, i)


@pytest.mark.cuda
def test_card_vmap_batch_of_eight_is_one_launch(card_fits):
    """B = 8 under ``torch.func.vmap``: one launch, each lane bitwise its
    single launch and the plain version."""
    _, calls = card_fits
    group = [c for c in calls if c.line == calls[0].line][:8]
    assert len(group) == 8
    first = group[0]
    singles = [c.run(corr_fit.corr_fit) for c in group]

    def stack(get):
        return torch.stack([get(c) for c in group])

    tensors = [stack(lambda c: c.edge.pts), stack(lambda c: c.edge.payload),
               stack(lambda c: c.edge.ok), stack(lambda c: c.pe),
               stack(lambda c: c.e_mask), stack(lambda c: c.planar.pts),
               stack(lambda c: c.planar.payload), stack(lambda c: c.planar.ok),
               stack(lambda c: c.pp), stack(lambda c: c.p_mask)]

    def one(ep, epay, eok, pe, em, pp_, ppay, pok, pp, pm):
        fit = corr_fit.corr_fit(
            first.edge._replace(pts=ep, payload=epay, ok=eok), pe, em,
            first.planar._replace(pts=pp_, payload=ppay, ok=pok), pp, pm,
            first.cfg, line=first.line)
        return tuple(x for x in fit if x is not None)

    n0 = _launches()
    batched = torch.func.vmap(one)(*tensors)
    torch.cuda.synchronize()
    assert _launches() - n0 == 1
    for i, (single, call) in enumerate(zip(singles, group)):
        lane = [b[i] for b in batched]
        want = [x for x in single if x is not None]
        assert all(torch.equal(_bits(g), _bits(w))
                   for g, w in zip(lane, want)), i
        assert _differs(single, call.run(corr_fit.corr_fit_reference)) == []


@pytest.mark.cuda
def test_card_graph_replays_give_the_same_bits(card_fits):
    _, calls = card_fits
    call = calls[-1]
    eager = call.run(corr_fit.corr_fit)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call.run(corr_fit.corr_fit)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert _differs(out, eager) == []


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["dense", "hash"])
def test_card_captured_lidar_step_launches_once_per_fit(engine):
    """Captured LiDAR steps at 16 x 256: 9 wrapper calls a frame at each
    graph's warm-up and capture, and 9 ``corr_fit_kernel`` launches in each
    replayed frame; the replays' poses equal the eager steps'."""
    dev = _card()
    from torch.profiler import ProfilerActivity, profile

    cfg = _small_config(nn_engine=engine)
    grids, masks = _drive(4, cfg)
    eager = odometry.init_carry(cfg, dev)
    poses = []
    for f in range(4):
        eager, out = odometry.step(eager, grids[f].to(dev), masks[f].to(dev),
                                   cfg)
        poses.append(out.T_w.clone())
    graphs.release()
    n0 = _launches()
    carry = odometry.init_carry(cfg, dev)
    for f in range(2):  # captures the cadence keys of frames 0 and 1
        carry, out = odometry.jit_step(carry, grids[f].to(dev),
                                       masks[f].to(dev), cfg)
        assert torch.equal(out.T_w, poses[f])
    assert _launches() - n0 == 9 * 2 * len(graphs.captures())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for f in range(2, 4):
            carry, out = odometry.jit_step(carry, grids[f].to(dev),
                                           masks[f].to(dev), cfg)
            assert torch.equal(out.T_w, poses[f])
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    n = sum(1 for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == cuda and "corr_fit_kernel" in ev.name())
    assert n == 9 * 2
    graphs.release()
