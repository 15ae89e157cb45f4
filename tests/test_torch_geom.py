"""Port parity: SE(3) utilities, the closed-form 3x3 eigensolver and the
pinhole camera.

The same numpy inputs go through ``velo_tpu`` (JAX, CPU) and
``velo_tpu_torch``.  Tolerance atol 1e-5: both run float32 with the same
formulas, and the backends' sin/cos/arccos differ in the last bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velo_tpu.geom import camera as jcam
from velo_tpu.geom import linalg as jlin
from velo_tpu.geom import se3 as jse3
from velo_tpu.io import fixtures
from velo_tpu_torch.geom import camera as tcam
from velo_tpu_torch.geom import linalg as tlin
from velo_tpu_torch.geom import se3 as tse3

torch.set_num_threads(1)

ATOL = 1e-5


def _xis(kind: str) -> np.ndarray:
    rng = np.random.default_rng({"random": 0, "small": 1, "zero": 2,
                                 "near_pi": 3}[kind])
    rho = rng.normal(0, 2.0, (64, 3))
    axis = rng.normal(size=(64, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    if kind == "random":
        phi = axis * rng.uniform(0.0, 2.5, (64, 1))
    elif kind == "small":
        phi = axis * rng.uniform(0.0, 1e-6, (64, 1))
    elif kind == "zero":
        phi = np.zeros((64, 3))
    else:
        phi = axis * rng.uniform(np.pi - 1e-3, np.pi - 1e-5, (64, 1))
    return np.concatenate([rho, phi], axis=1).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "small", "zero", "near_pi"])
def test_exp_log_match_reference(kind):
    xi = _xis(kind)
    T_j = np.asarray(jse3.exp(jnp.asarray(xi)))
    T_t = tse3.exp(torch.tensor(xi)).numpy()
    np.testing.assert_allclose(T_t, T_j, atol=ATOL)
    lg_j = np.asarray(jse3.log(jnp.asarray(T_j)))
    lg_t = tse3.log(torch.tensor(T_j)).numpy()
    np.testing.assert_allclose(lg_t[:, 3:], lg_j[:, 3:], atol=ATOL)
    # Near pi the inverse left Jacobian's cot term amplifies float32
    # rounding ~1/sin(theta)-fold: the reference itself recovers rho only
    # to ~3e-4 there, so the translation part gets 2e-3.
    np.testing.assert_allclose(lg_t[:, :3], lg_j[:, :3],
                               atol=2e-3 if kind == "near_pi" else ATOL)


def test_inv_apply_interp_match_reference():
    rng = np.random.default_rng(4)
    xi = _xis("random")[:8]
    T = np.asarray(jse3.exp(jnp.asarray(xi)))
    pts = rng.uniform(-30, 30, (8, 100, 3)).astype(np.float32)
    s = rng.uniform(0, 1, 8).astype(np.float32)
    np.testing.assert_allclose(tse3.inv(torch.tensor(T)).numpy(),
                               np.asarray(jse3.inv(jnp.asarray(T))),
                               atol=ATOL)
    # Points up to 30 m: float32 leaves ~4e-6 m of rounding per product.
    np.testing.assert_allclose(
        tse3.apply(torch.tensor(T), torch.tensor(pts)).numpy(),
        np.asarray(jse3.apply(jnp.asarray(T), jnp.asarray(pts))), atol=1e-4)
    np.testing.assert_allclose(
        tse3.interp(torch.tensor(T), torch.tensor(s)).numpy(),
        np.asarray(jse3.interp(jnp.asarray(T), jnp.asarray(s))), atol=ATOL)


def test_sym_eig3x3_matches_reference():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(512, 3, 3))
    A = (A @ np.swapaxes(A, 1, 2)).astype(np.float32)  # well separated PSD
    ev_j, V_j = (np.asarray(x) for x in jlin.sym_eig3x3(jnp.asarray(A)))
    ev_t, V_t = (x.numpy() for x in tlin.sym_eig3x3(torch.tensor(A)))
    np.testing.assert_allclose(ev_t, ev_j, atol=ATOL, rtol=1e-5)
    # Eigenvectors are defined up to sign.
    dots = np.abs(np.einsum("bij,bij->bj", V_t, V_j))
    np.testing.assert_allclose(dots, 1.0, atol=ATOL)
    np.testing.assert_allclose(ev_t, np.linalg.eigvalsh(A), rtol=1e-4,
                               atol=1e-4)


def test_camera_matches_reference():
    """project / project_depth / backproject / normalized_ray / in_image on
    the fixture calibration, with points in front of, behind and beside
    the camera.  Pixels to 1e-3 (|x| up to ~4e4 before the division),
    depths and rays to 1e-5 relative."""
    P, T = fixtures.default_calib(128, 384)
    cam_j = jcam.Camera(P=jnp.asarray(P, jnp.float32),
                        T_cam_velo=jnp.asarray(T, jnp.float32),
                        width=384, height=128)
    cam_t = tcam.from_numpy(P, T, 384, 128, "cpu")
    np.testing.assert_array_equal(cam_t.P.numpy(), np.asarray(cam_j.P))
    assert float(cam_t.fx) == float(cam_j.fx)
    assert float(cam_t.cy) == float(cam_j.cy)
    rng = np.random.default_rng(6)
    pts = np.stack([rng.uniform(-20, 20, 512), rng.uniform(-5, 5, 512),
                    rng.uniform(-5, 60, 512)], -1).astype(np.float32)
    pts[:4, 2] = [0.0, 1e-7, -1.0, 2e-6]  # the guard around z = 0
    uv_j, v_j = jcam.project(cam_j.P, jnp.asarray(pts))
    uv_t, v_t = tcam.project(cam_t.P, torch.tensor(pts))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-5,
                               atol=1e-3)
    _, z_j, _ = jcam.project_depth(cam_j.P, jnp.asarray(pts))
    _, z_t, _ = tcam.project_depth(cam_t.P, torch.tensor(pts))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-5,
                               atol=1e-5)
    uv = np.stack([rng.uniform(-10, 394, 512), rng.uniform(-10, 138, 512)],
                  -1).astype(np.float32)
    depth = rng.uniform(1, 50, 512).astype(np.float32)
    np.testing.assert_allclose(
        tcam.backproject(cam_t, torch.tensor(uv), torch.tensor(depth)).numpy(),
        np.asarray(jcam.backproject(cam_j, jnp.asarray(uv),
                                    jnp.asarray(depth))), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(
        tcam.normalized_ray(cam_t, torch.tensor(uv)).numpy(),
        np.asarray(jcam.normalized_ray(cam_j, jnp.asarray(uv))), atol=1e-6)
    for margin in (0.0, 2.5):
        np.testing.assert_array_equal(
            tcam.in_image(cam_t, torch.tensor(uv), margin).numpy(),
            np.asarray(jcam.in_image(cam_j, jnp.asarray(uv), margin)))
