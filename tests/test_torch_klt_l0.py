"""The level-0 KLT kernel: its plain PyTorch version against the Pallas
reference (interpret mode, as ``klt._track_level`` runs it off the TPU),
the full forward-backward ``track()`` with ``klt_impl="pallas"`` against
JAX's, and the CUDA kernel against the plain version on the card.

Tolerances are those of ``tests/unit/test_klt_l0.py``: ``ok`` agreeing on
> 95 % of tracks and < 1e-2 px where both are ok at one level (both run
float32 in the same operation order up to the reference's reduction
order); > 90 % and < 0.05 px for the full track.

JAX is imported inside the tests that need it, so that the card-only tests
run on a GPU machine without JAX:
``python -m pytest --noconftest tests/test_torch_klt_l0.py -m cuda``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from scipy.ndimage import map_coordinates

from velo_tpu_torch import config as tconfig
from velo_tpu_torch.evaluation import profiling
from velo_tpu_torch.kernels import klt_l0 as tk


def _launches() -> int:
    """The klt_l0 kernel's launches so far in this process."""
    return profiling.counters().get("kernel.klt_l0", (0, 0.0))[0]


torch.set_num_threads(1)


def _setup(seed=0, H=64, W=512, K=32):
    """The inputs of ``tests/unit/test_klt_l0.py``: a blocky random image,
    the same image shifted by (1.3, -0.7) px, K positions and guesses."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 1.0, (H // 4, W // 4))
    img = np.kron(img, np.ones((4, 4)))
    img = (img + rng.uniform(0, 0.05, (H, W))).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    cur = map_coordinates(img, [yy - 0.7, xx + 1.3], order=1,
                          mode="nearest").astype(np.float32)
    uv_prev = np.stack([rng.uniform(24, W - 24, K),
                        rng.uniform(16, H - 16, K)], 1).astype(np.float32)
    uv_cur = uv_prev + rng.uniform(-2, 2, (K, 2)).astype(np.float32)
    return img, cur, uv_prev, uv_cur


def _with_bad_tracks(uv):
    """Append tracks at the image corner, past the right edge, and NaN."""
    bad = np.array([[2.0, 2.0], [500.0, 60.0], [np.nan, np.nan]], np.float32)
    return np.concatenate([uv, bad])


def _edge_setup(H=64, W=512, with_inf=False):
    """An image pair with a flat patch, and tracks on every edge of the
    contract: NaN in one or both coordinates, the image corner, the last
    position whose template support fits (floor(x) - 7 = 1, floor(x) + 9 =
    W - 1; likewise y) and the first that does not, a textureless window
    (det = 0), a start far from the template position, a start on the
    image border (every step frozen), and positions far outside."""
    prev, cur, _, _ = _setup(9, H, W, 1)
    prev[H // 2 - 14:H // 2 + 14, 100:160] = 0.5
    cur[H // 2 - 14:H // 2 + 14, 100:160] = 0.5
    nan = np.nan
    ym = float(H // 2)
    uv_prev = np.array([
        [nan, nan], [nan, ym], [200.0, nan], [2.0, 2.0],
        [8.0, ym], [7.99, ym], [W - 9.01, ym], [W - 9.0, ym],
        [300.5, 8.0], [300.5, 7.5], [300.5, H - 9.01], [300.5, H - 9.0],
        [130.0, ym], [250.25, ym - 3.5], [260.75, ym + 2.5],
        [270.5, ym], [280.5, ym], [-5.0, -5.0], [1e9, 1e9],
        [400.3, ym + 1.7]], np.float32)
    uv_cur = uv_prev.copy()
    uv_cur[13] += [1.0, -0.5]
    uv_cur[14] += [30.0, 4.0]  # far from the template position
    uv_cur[15] = [3.0, ym]  # patch leaves the image: frozen from the start
    uv_cur[16] = [nan, ym]
    uv_cur[19] += [-1.2, 0.6]
    if with_inf:
        uv_prev = np.concatenate(
            [uv_prev, [[np.inf, ym], [300.0, -np.inf]]]).astype(np.float32)
        uv_cur = np.concatenate(
            [uv_cur, [[300.0, ym], [np.inf, np.inf]]]).astype(np.float32)
    return prev, cur, uv_prev, uv_cur


def _both(inputs, iters):
    import jax.numpy as jnp

    from velo_tpu.config import VisionConfig
    from velo_tpu.pallas import klt_l0 as jk

    prev = inputs[0]
    H, W = prev.shape
    uj, okj = jk.track_level0(*(jnp.asarray(a) for a in inputs),
                              VisionConfig(height=H, width=W), iters,
                              interpret=True)
    ut, okt = tk.track_level0(*(torch.tensor(a) for a in inputs),
                              tconfig.VisionConfig(height=H, width=W), iters)
    return np.asarray(uj), np.asarray(okj), ut.numpy(), okt.numpy()


@pytest.mark.parametrize("shape,iters,seed", [
    ((64, 512, 32), 4, 4), ((64, 512, 32), 8, 8), ((128, 384, 128), 8, 1)])
def test_plain_matches_pallas_reference(shape, iters, seed):
    H, W, K = shape
    uj, okj, ut, okt = _both(_setup(seed, H, W, K), iters)
    assert okt.dtype == bool and ut.dtype == np.float32
    assert (okt == okj).mean() > 0.95
    both = okt & okj
    assert both.sum() >= 20
    assert np.abs(ut[both] - uj[both]).max() < 1e-2


def test_out_of_image_and_nan_tracks_freeze():
    prev, cur, uv_prev, uv_cur = _setup(5)
    inputs = (prev, cur, _with_bad_tracks(uv_prev[:5]),
              _with_bad_tracks(uv_cur[:5]))
    uj, okj, ut, okt = _both(inputs, 4)
    np.testing.assert_array_equal(okt, okj)
    assert not okt[5:].any()
    # Frozen tracks return their initial position; a NaN one returns -1e6.
    np.testing.assert_array_equal(ut[5:7], inputs[3][5:7])
    np.testing.assert_array_equal(ut[7], [-1e6, -1e6])
    np.testing.assert_array_equal(uj[5:], ut[5:])


@pytest.mark.parametrize("iters", [4, 8])
def test_edge_tracks_match_pallas_reference(iters):
    inputs = _edge_setup()
    uj, okj, ut, okt = _both(inputs, iters)
    np.testing.assert_array_equal(okt, okj)
    # The template test: the last position that fits is ok, the first
    # that does not is not; NaN, corner, flat and far-outside tracks fail.
    expect_ok = {4: True, 5: False, 6: True, 7: False, 8: True, 9: False,
                 10: True, 11: False, 12: False, 13: True, 19: True}
    for track, ok in expect_ok.items():
        assert okt[track] == ok, track
    assert not okt[[0, 1, 2, 3, 16, 17, 18]].any()
    # Tracks that never step return their start (NaN reads -1e6) exactly.
    frozen = [0, 1, 2, 3, 5, 7, 9, 11, 12, 15, 16, 17, 18]
    start = np.nan_to_num(inputs[3], nan=-1e6)
    np.testing.assert_array_equal(ut[frozen], start[frozen])
    np.testing.assert_array_equal(uj[frozen], ut[frozen])
    assert np.abs(ut[okt] - uj[okt]).max() < 1e-2


def test_converges_to_true_flow():
    prev, cur, uv_prev, _ = _setup(3)
    cfg = tconfig.VisionConfig(height=64, width=512)
    uv, ok = tk.track_level0(torch.tensor(prev), torch.tensor(cur),
                             torch.tensor(uv_prev), torch.tensor(uv_prev),
                             cfg, 8)
    flow = (uv.numpy() - uv_prev)[ok.numpy()]
    assert len(flow) >= 20
    # cur(x) = prev(x + d): features land at x - d, flow (-1.3, +0.7).
    assert np.abs(np.median(flow, 0) - [-1.3, 0.7]).max() < 0.2


def test_track_pipeline_with_pallas_impl():
    """Full forward + FB ``track()`` at 64 x 512 (level 0 through the
    kernel's plain version, coarse levels on the gather path) against
    JAX's ``track()`` with the same ``klt_impl``."""
    import jax.numpy as jnp

    from velo_tpu.config import VisionConfig
    from velo_tpu.vision import klt as jklt
    from velo_tpu.vision import pyramid as jpyr
    from velo_tpu_torch.vision import klt as tklt
    from velo_tpu_torch.vision import pyramid as tpyr

    prev, cur, uv_prev, _ = _setup(7, H=64, W=512, K=48)
    base = dict(height=64, width=512, pyr_levels=3, k_tracks=48,
                klt_impl="pallas")
    valid = np.ones(48, bool)
    pp, cp = (jpyr.build_pyramid(jnp.asarray(x), 3) for x in (prev, cur))
    rj = jklt.track(pp, cp, jklt.frame_gradients(pp),
                    jklt.frame_gradients(cp), jnp.asarray(uv_prev),
                    jnp.asarray(valid), VisionConfig(**base))
    pp, cp = (tpyr.build_pyramid(torch.tensor(x), 3) for x in (prev, cur))
    rt = tklt.track(pp, cp, tklt.frame_gradients(pp),
                    tklt.frame_gradients(cp), torch.tensor(uv_prev),
                    torch.tensor(valid), tconfig.VisionConfig(**base))
    okj, okt = np.asarray(rj.ok), rt.ok.numpy()
    assert (okj == okt).mean() > 0.9
    both = okj & okt
    assert both.sum() >= 30
    d = np.abs(np.asarray(rj.uv)[both] - rt.uv.numpy()[both]).max()
    assert d < 0.05, d


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    args = [torch.tensor(a) for a in _setup(2)]
    cfg = tconfig.VisionConfig(height=64, width=512)
    before = _launches()
    a = tk.track_level0(*args, cfg, 6)
    b = tk.track_level0_reference(*args, cfg, 6)
    assert _launches() == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    n_tmpl, n_steps, n_px = tk.work(*args, cfg, 6)
    assert int(a[1].sum()) <= n_tmpl <= 32 and n_steps <= 6 * n_tmpl
    assert 18 * 18 < n_px <= 18 * 18 * n_tmpl + 16 * 16 * n_steps
    # One track: its 18x18 template support, then each applied step's
    # 16x16 patch support in the current image.
    one = [args[0], args[1], args[2][:1], args[3][:1]]
    assert tk.work(*one, cfg, 0) == (1, 0, 18 * 18)
    _, s1, px1 = tk.work(*one, cfg, 1)
    assert s1 == 1 and px1 == 18 * 18 + 16 * 16


@pytest.mark.parametrize("change", [
    {"shape": (64, 500)}, {"shape": (60, 512)}, {"shape": (40, 512)},
    {"halfwin": 5}, {"dtype": torch.float64}, {"iters": -1}])
def test_wrapper_refuses_what_the_kernel_does_not_take(change):
    H, W = change.get("shape", (64, 512))
    prev = torch.zeros((H, W), dtype=change.get("dtype", torch.float32))
    uv = torch.full((4, 2), 30.0)
    cfg = tconfig.VisionConfig(height=H, width=W,
                               klt_halfwin=change.get("halfwin", 7))
    with pytest.raises((ValueError, TypeError)):
        tk.track_level0(prev, prev, uv, uv, cfg, change.get("iters", 4))


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [8, 4])
def test_kernel_bitwise_equals_plain_on_card(iters):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    prev, cur, uv_prev, uv_cur = _setup(11, H=192, W=640, K=253)
    inputs = [torch.tensor(a, device=dev)
              for a in (prev, cur, _with_bad_tracks(uv_prev),
                        _with_bad_tracks(uv_cur))]
    cfg = dataclasses.replace(tconfig.VisionConfig(), klt_impl="pallas")
    before = _launches()
    uv, ok = tk.track_level0(*inputs, cfg, iters)
    ruv, rok = tk.track_level0_reference(*inputs, cfg, iters)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    assert uv.dtype == torch.float32 and ok.dtype == torch.bool
    assert torch.equal(ok, rok)
    assert torch.equal(uv, ruv)
    assert int(ok.sum()) > 200
    cpu_uv, cpu_ok = tk.track_level0(*(x.cpu() for x in inputs), cfg, iters)
    assert torch.equal(cpu_ok, ok.cpu()) and torch.equal(cpu_uv, uv.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [8, 4, 0])
def test_kernel_bitwise_equals_plain_on_card_edge_tracks(iters):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    inputs = [torch.tensor(a, device=dev)
              for a in _edge_setup(192, 640, with_inf=True)]
    cfg = dataclasses.replace(tconfig.VisionConfig(), klt_impl="pallas")
    uv, ok = tk.track_level0(*inputs, cfg, iters)
    ruv, rok = tk.track_level0_reference(*inputs, cfg, iters)
    torch.cuda.synchronize()
    assert torch.equal(ok, rok)
    assert torch.equal(uv, ruv)
    assert 4 <= int(ok.sum()) <= 8


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [8, 4])
@pytest.mark.parametrize("shared", [False, True], ids=["batched", "shared"])
def test_vmapped_kernel_is_one_batched_launch_on_card(iters, shared,
                                                      monkeypatch):
    """The batch mode's shapes (128 x 384, K = 128) for four sequences
    under torch.func.vmap, images batched or shared at batch stride 0: one
    launch, each sequence bitwise equal to its unbatched launch and to the
    plain version, and the plain version never reached on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    sets = [_setup(30 + b, H=128, W=384, K=128) for b in range(4)]
    prev, cur, up, uc = (torch.tensor(np.stack(x), device=dev)
                         for x in zip(*sets))
    cfg = dataclasses.replace(
        tconfig.VisionConfig(height=128, width=384), klt_impl="pallas")

    def plain_reached(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    before = _launches()
    with monkeypatch.context() as m:
        m.setattr(tk, "_plain", plain_reached)
        if shared:
            uv, ok = torch.func.vmap(lambda a, b: tk.track_level0(
                prev[0], cur[0], a, b, cfg, iters))(up, uc)
        else:
            uv, ok = torch.func.vmap(lambda *x: tk.track_level0(
                *x, cfg, iters))(prev, cur, up, uc)
        torch.cuda.synchronize()
    assert _launches() == before + 1
    assert uv.shape == (4, 128, 2) and ok.shape == (4, 128)
    for b in range(4):
        j = 0 if shared else b
        args = (prev[j], cur[j], up[b], uc[b], cfg, iters)
        one, ref = tk.track_level0(*args), tk.track_level0_reference(*args)
        assert torch.equal(uv[b], one[0]) and torch.equal(ok[b], one[1])
        assert torch.equal(uv[b], ref[0]) and torch.equal(ok[b], ref[1])
    assert int(ok.sum()) > 300
