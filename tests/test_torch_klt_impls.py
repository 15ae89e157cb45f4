"""Port parity of the reference's other samplers and top-k, and of the
public helpers: the selection-matmul and local-window KLT samplers
(``klt_impl="matmul"`` / ``"window"``), ``dense_nn.knn`` with
``approx_impl="xla"``, and
``se3.vee`` / ``se3.apply_one`` / ``residuals.plane_from_3pts`` /
``local_map.to_grid``.

The same numpy arrays go through ``velo_tpu`` (JAX, CPU) and
``velo_tpu_torch``.  Tolerances:
* samplers 1e-6 on [0, 1] images: a selection product has two non-zero
  terms per output (bfloat16 operands multiply exactly in float32), so
  only a contracted multiply-add can move the last bit;
* a KLT level: ``ok`` equal on >= 95 % of the tracks; where both
  track, positions within 1e-4 px in the median and 0.05 px at most (the
  tolerance of ``test_torch_klt_l0.py``'s ``track()`` test): the port
  sums the normal equations in float64, JAX in float32, and on
  bfloat16-rounded patches an ill-conditioned track moves a few
  hundredths of a pixel with that order;
* one fused step from a shared carry: the one-step gate of
  ``test_torch_odometry.py``, 1 cm / 0.05 deg;
* the helpers 1e-6.
The window impl's fused step is in ``test_torch_klt_window.py``: each JAX
compile of a fused step takes ~20-40 s here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velo_tpu import config as jconfig
from velo_tpu.geom import camera as jcam
from velo_tpu.geom import se3 as jse3
from velo_tpu.io import fixtures
from velo_tpu.lidar import rangeimage as jri
from velo_tpu.mapping import dense_nn as jnn
from velo_tpu.mapping import local_map as jlm
from velo_tpu.pipeline import odometry as jodo
from velo_tpu.solve import residuals as jres
from velo_tpu.vision import klt as jklt
from velo_tpu.vision import pyramid as jpyr
from velo_tpu_torch import config as tconfig
from velo_tpu_torch.geom import camera as tcam
from velo_tpu_torch.geom import se3 as tse3
from velo_tpu_torch.mapping import dense_nn as tnn
from velo_tpu_torch.mapping import local_map as tlm
from velo_tpu_torch.pipeline import odometry as todo
from velo_tpu_torch.solve import residuals as tres
from velo_tpu_torch.vision import klt as tklt
from velo_tpu_torch.vision import pyramid as tpyr

torch.set_num_threads(1)

H, W, K = 128, 384, 96


def _pose_diff(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    R = a[:3, :3].T @ b[:3, :3]
    sin = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                          R[1, 0] - R[0, 1]]) / 2.0
    cos = (np.trace(R) - 1.0) / 2.0
    return (float(np.linalg.norm(a[:3, 3] - b[:3, 3])),
            float(np.degrees(np.arctan2(sin, cos))))


@pytest.fixture(scope="module")
def images():
    """Two consecutive fixture frames and K corner-like positions, a few
    of them at and beyond the border."""
    fx = fixtures.make_fixture(n_frames=2, n_rings=16, n_azimuth=256,
                               height=H, width=W, seed=5)
    rng = np.random.default_rng(0)
    uv = np.stack([rng.uniform(10, W - 10, K), rng.uniform(10, H - 10, K)],
                  -1).astype(np.float32)
    uv[:4] = [[2.5, 60.2], [W - 3.3, 40.7], [100.4, 1.2], [-4.0, 70.0]]
    return (np.asarray(fx.images[0], np.float32),
            np.asarray(fx.images[1], np.float32), uv)


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_matmul_samplers(images, dtype):
    prev, cur, uv = images
    jd = jnp.bfloat16 if dtype else None
    td = torch.bfloat16 if dtype else None
    pj, ij = jpyr.bilinear_patches_matmul(jnp.asarray(prev), jnp.asarray(uv),
                                          7, dtype=jd)
    pt, it = tpyr.bilinear_patches_matmul(torch.tensor(prev),
                                          torch.tensor(uv), 7, dtype=td)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    assert np.array_equal(it.numpy(), np.asarray(ij))
    stack = np.stack([prev, cur, prev - cur])
    pj, ij = jpyr.bilinear_patches_matmul_multi(jnp.asarray(stack),
                                                jnp.asarray(uv), 7, dtype=jd)
    pt, it = tpyr.bilinear_patches_matmul_multi(torch.tensor(stack),
                                                torch.tensor(uv), 7,
                                                dtype=td)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    assert np.array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_window_samplers(images, dtype):
    prev, cur, uv = images
    jd = jnp.bfloat16 if dtype else None
    td = torch.bfloat16 if dtype else None
    tl = (np.floor(uv).astype(np.int32) - 15)
    stack = np.stack([prev, cur])
    wj = jpyr.integer_windows(jnp.asarray(stack), jnp.asarray(tl), 32,
                              dtype=jd)
    wt = tpyr.integer_windows(torch.tensor(stack), torch.tensor(tl), 32,
                              dtype=td)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-6)
    luv = (uv - tl).astype(np.float32)
    luv[5] = [30.5, 3.0]  # leaves the window
    pj, ij = jpyr.bilinear_patches_local(wj[0], jnp.asarray(luv), 7)
    pt, it = tpyr.bilinear_patches_local(torch.tensor(np.asarray(wj[0])),
                                         torch.tensor(luv), 7)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    assert np.array_equal(it.numpy(), np.asarray(ij))
    assert not it[5]


@pytest.mark.parametrize("impl", ["matmul", "window"])
def test_klt_level(images, impl):
    """One level-0 IC-LK level, template in frame 0, start in frame 1."""
    prev, cur, uv = images
    vj = dataclasses.replace(jconfig.tiny_test_config().vision,
                             klt_impl=impl)
    vt = dataclasses.replace(tconfig.tiny_test_config().vision,
                             klt_impl=impl)
    gj = jpyr.scharr_gradients(jnp.asarray(prev))
    uj, okj = jklt._track_level(jnp.asarray(prev), *gj, jnp.asarray(cur),
                                jnp.asarray(uv), jnp.asarray(uv), vj)
    gt = tpyr.scharr_gradients(torch.tensor(prev))
    ut, okt = tklt._track_level(torch.tensor(prev), *gt, torch.tensor(cur),
                                torch.tensor(uv), torch.tensor(uv), vt)
    okj, okt = np.asarray(okj), okt.numpy()
    assert (okj == okt).mean() >= 0.95
    both = okj & okt
    assert both.sum() >= K // 2
    d = np.abs(np.asarray(uj)[both] - ut.numpy()[both]).max(axis=1)
    assert np.median(d) < 1e-4 and d.max() < 0.05, (np.median(d), d.max())


def test_knn_xla_is_the_exact_search_in_jax_order():
    """``approx_max_k`` is exact off the TPU: the same neighbours in the
    same order, duplicated targets (ties) included."""
    rng = np.random.default_rng(3)
    t = rng.normal(size=(4096, 3)).astype(np.float32)
    t[100:110] = t[50]  # ties: lax.top_k keeps the lower index first
    tmask = rng.random(4096) > 0.1
    q = rng.normal(size=(300, 3)).astype(np.float32)
    q[0] = t[50]
    qmask = rng.random(300) > 0.05
    ij, dj, vj = jnn.knn(jnn.make_targets(jnp.asarray(t), jnp.asarray(tmask)),
                         jnp.asarray(q), jnp.asarray(qmask), 16, 1.5,
                         approx=True, approx_impl="xla")
    it, dt, vt = tnn.knn(tnn.make_targets(torch.tensor(t),
                                          torch.tensor(tmask)),
                         torch.tensor(q), torch.tensor(qmask), 16, 1.5,
                         approx=True, approx_impl="xla")
    live = np.asarray(qmask)
    assert np.array_equal(it.numpy()[live], np.asarray(ij)[live])
    assert np.array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(dt.numpy()[live], np.asarray(dj)[live],
                               atol=1e-5)
    with pytest.raises(ValueError, match="nn_approx_impl"):
        tnn.knn(tnn.make_targets(torch.tensor(t), torch.tensor(tmask)),
                torch.tensor(q), torch.tensor(qmask), 16, 1.5, approx=True,
                approx_impl="bogus")


def test_helpers():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    Wm = np.asarray(jse3.hat(jnp.asarray(w)))
    np.testing.assert_allclose(tse3.vee(torch.tensor(Wm)).numpy(),
                               np.asarray(jse3.vee(jnp.asarray(Wm))),
                               atol=1e-6)
    T = np.asarray(jse3.exp(jnp.asarray(
        rng.normal(size=(5, 6)).astype(np.float32) * 0.3)))
    p = rng.normal(size=(5, 3)).astype(np.float32) * 10
    np.testing.assert_allclose(
        tse3.apply_one(torch.tensor(T), torch.tensor(p)).numpy(),
        np.asarray(jse3.apply_one(jnp.asarray(T), jnp.asarray(p))),
        atol=1e-5, rtol=1e-6)
    a, b, c = (rng.normal(size=(6, 3)).astype(np.float32) for _ in range(3))
    c[0] = a[0] + 2.0 * (b[0] - a[0])  # collinear: gated
    valid = np.array([True] * 5 + [False])
    nj, dj, okj = jres.plane_from_3pts(*map(jnp.asarray, (a, b, c, valid)))
    nt, dtt, okt = tres.plane_from_3pts(*map(torch.tensor, (a, b, c, valid)))
    assert np.array_equal(okt.numpy(), np.asarray(okj)) and not okt[0]
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-6)
    np.testing.assert_allclose(dtt.numpy(), np.asarray(dj), atol=1e-6)

    pts = (rng.normal(size=(512, 3)) * 5).astype(np.float32)
    mask = rng.random(512) > 0.2
    cen = np.array([0.5, -0.25, 0.1], np.float32)
    gj = jlm.to_grid(jlm.LocalMap(jnp.asarray(pts), jnp.asarray(mask),
                                  jnp.int32(0)), jnp.asarray(cen), 0.8)
    gt = tlm.to_grid(tlm.LocalMap(torch.tensor(pts), torch.tensor(mask),
                                  torch.tensor(0, dtype=torch.int32)),
                     torch.tensor(cen), 0.8)
    assert np.array_equal(gt.keys.numpy(), np.asarray(gj.keys))
    np.testing.assert_allclose(gt.pts.numpy(), np.asarray(gj.pts), atol=1e-6)
    assert gt.voxel_size == gj.voxel_size


def fused_step_pair(impl, frame):
    """JAX's fused step with ``klt_impl=impl`` over frames 0-1 of the
    tiny fused drive, and the port's step from the carry JAX entered
    ``frame`` with -> (JAX pose, port pose)."""
    base = jconfig.tiny_test_config()
    cfg = dataclasses.replace(base, use_vision=True, use_map=True,
                              prebin_host=True, vision=dataclasses.replace(
                                  base.vision, klt_impl=impl))
    vc = cfg.vision
    fx = fixtures.make_fixture(n_frames=2, n_rings=cfg.lidar.n_rings,
                               n_azimuth=cfg.lidar.n_azimuth,
                               height=vc.height, width=vc.width, seed=3)
    cam = jcam.Camera(P=jnp.asarray(fx.P, jnp.float32),
                      T_cam_velo=jnp.asarray(fx.T_cam_velo, jnp.float32),
                      width=vc.width, height=vc.height)
    carry = jodo.init_carry(cfg)
    for f in range(frame + 1):
        entering = jax.tree.map(np.asarray, carry)
        g, v = jri.bin_scan_host(fx.scans[f], cfg.lidar)
        carry, out = jodo.jit_step(carry, jnp.asarray(g), jnp.asarray(v),
                                   cfg, image=jnp.asarray(fx.images[f]),
                                   cam=cam)
    _, res = todo.step(
        todo.carry_from_jax_numpy(entering, device="cpu"), torch.tensor(g),
        torch.tensor(v), cfg, image=torch.tensor(fx.images[frame]),
        cam=tcam.from_numpy(fx.P, fx.T_cam_velo, vc.width, vc.height, "cpu"))
    return np.asarray(out.T_w), res.T_w.numpy()


@pytest.mark.parametrize("frame", [0, 1])
def test_fused_step_matmul(frame):
    dt, dr = _pose_diff(*fused_step_pair("matmul", frame))
    assert dt < 0.01 and dr < 0.05, (dt, dr)
