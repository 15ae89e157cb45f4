"""Drive simulation on a torch device: frozen copy of
``velo_tpu_torch/io/fixtures_accel.py`` (the program's ``VELO_FIX_ACCEL=1``
raycaster) for the benchmark.

:func:`benchmarks.drive.fixtures.make_fixture` calls it when given a
device.  The rays of every frame are built with the numpy code (float64,
then cast to float32); the slab raycast and the camera shading run in
float32 torch on the device, a 64 x 2048 sweep's worth of rays at a time;
range noise, gating and the min-range filter (:func:`finish_scan`) stay in
numpy on the host, so the numpy RNG is drawn in the numpy path's order.
Ray-hit distances are float32, ~1e-5 m at 80 m against the float64 numpy
path, far below the 2 cm sensor-noise floor.
"""
from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def _sin(x: torch.Tensor) -> torch.Tensor:
    """sin rounded once from float64: the same bits on the card and CPU."""
    return torch.sin(x.to(F64)).to(x.dtype)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c with one rounding (the float64 product of two float32
    values is exact)."""
    return (a.to(F64) * b.to(F64) + c.to(F64)).to(a.dtype)


# Rays per device chunk: one 64 x 2048 sweep, 88 boxes -> (chunk, B, 3)
# float32 temporaries of ~140 MB each on the card.
CHUNK = 64 * 2048


def _chunks(origins, dirs, chunk, dev):
    """(start, origins, dirs) of each run of ``chunk`` rays of the
    flattened (F, N, 3) float32 arrays, copied to ``dev``."""
    o_all = torch.from_numpy(np.ascontiguousarray(origins, np.float32))
    d_all = torch.from_numpy(np.ascontiguousarray(dirs, np.float32))
    o_all, d_all = o_all.reshape(-1, 3), d_all.reshape(-1, 3)
    for s in range(0, o_all.shape[0], chunk):
        yield s, o_all[s:s + chunk].to(dev), d_all[s:s + chunk].to(dev)


def _fmac(a, b, c):
    """fma(a, b, c), one rounding, where a and c may be Python numbers
    (rounded to float32 first, as XLA rounds the reference's constants)."""
    def f32(v):
        return v if torch.is_tensor(v) else torch.full_like(b, v)
    return _fma(f32(a), b, f32(c))


def _slab(mins, maxs, o, d):
    """Per-axis slab entries and exits (chunk, B, 3) of rays o + t d."""
    inv_d = 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)
    o_ = o[:, None, :]
    inv_ = inv_d[:, None, :]
    t1 = (mins[None] - o_) * inv_
    t2 = (maxs[None] - o_) * inv_
    return torch.minimum(t1, t2), torch.maximum(t1, t2)


def _sweep_hits(mins, maxs, origins, dirs, t_max, chunk=CHUNK, *,
                device=None):
    """Device raycast: nearest-hit t for every (frame, ray).

    origins/dirs: (F, N, 3) float32 arrays.  Returns (F, N) float32 t with
    +inf for miss.  Mirrors fixtures.raycast exactly (same epsilons, same
    gating) in float32.
    """
    dev = torch.device(device)
    F, N = origins.shape[0], origins.shape[1]
    mins_d = torch.as_tensor(np.asarray(mins, np.float32), device=dev)
    maxs_d = torch.as_tensor(np.asarray(maxs, np.float32), device=dev)
    out = torch.empty(F * N, dtype=torch.float32, device=dev)
    for s, o, d in _chunks(origins, dirs, chunk, dev):
        tmin_ax, tmax_ax = _slab(mins_d, maxs_d, o, d)
        tmin = torch.maximum(torch.maximum(tmin_ax[..., 0], tmin_ax[..., 1]),
                             tmin_ax[..., 2])
        tmax = torch.minimum(torch.minimum(tmax_ax[..., 0], tmax_ax[..., 1]),
                             tmax_ax[..., 2])
        hit = (tmax >= tmin) & (tmax > 0) & (tmin < t_max)
        tmin = torch.where(hit & (tmin > 1e-6), tmin, torch.inf)
        out[s:s + chunk] = tmin.amin(dim=1)
    return out.cpu().numpy().reshape(F, N)


def _render_frames(world, origins, dirs, albedo, chunk=CHUNK, *,
                   device=None):
    """Device render path: t + winning box + normal + procedural shade.

    origins/dirs: (F, N, 3) float32 (camera rays, unit dirs).  Returns
    (F, N) float32 shade values, 0.08 where no hit, mirroring
    fixtures.render_camera + _procedural_shade in float32.  Unlike
    :func:`_sweep_hits` there is no far gate, as in the numpy renderer.
    """
    dev = torch.device(device)
    F, N = origins.shape[0], origins.shape[1]
    mins_d = torch.as_tensor(np.asarray(world.mins, np.float32), device=dev)
    maxs_d = torch.as_tensor(np.asarray(world.maxs, np.float32), device=dev)
    alb_d = torch.as_tensor(np.asarray(albedo, np.float32), device=dev)
    light = torch.tensor([0.4, 0.25, 0.88], dtype=torch.float32, device=dev)
    out = torch.empty(F * N, dtype=torch.float32, device=dev)
    for s, o, d in _chunks(origins, dirs, chunk, dev):
        tmin_ax, tmax_ax = _slab(mins_d, maxs_d, o, d)  # (chunk, B, 3)
        tmin = tmin_ax.amax(dim=2)
        tmax = tmax_ax.amin(dim=2)
        hit = (tmax >= tmin) & (tmax > 0)
        tmin = torch.where(hit & (tmin > 1e-6), tmin, torch.inf)
        t = tmin.amin(dim=1)
        has_hit = torch.isfinite(t)
        # One-hot winner, ties to the first box as argmin's.  Its products
        # with the per-box values are exact (one term is not zero), so no
        # matmul: on the card a float32 matmul may round.
        is_min = (tmin <= t[:, None]) & has_hit[:, None]
        first = torch.cumsum(is_min.to(torch.float32), dim=1) <= 1.0
        onehot = (is_min & first).to(torch.float32)  # (chunk, B)
        win_ax = (onehot[:, :, None] * tmin_ax).sum(dim=1)  # (chunk, 3)
        # The winning axis reproduces t bit-exactly (tmin is the max over
        # these same values), so a tiny epsilon suffices in float32.
        ax = (win_ax - t[:, None]).abs() < 1e-6
        ax_idx = torch.argmax(ax.to(torch.uint8), dim=1)  # first True
        normal = -torch.sign(torch.gather(d, 1, ax_idx[:, None]))
        normals = torch.zeros_like(d).scatter(1, ax_idx[:, None], normal)
        normals = torch.where(has_hit[:, None], normals, 0.0)
        alb = (onehot * alb_d).sum(dim=1)  # (chunk,)
        # The texture as XLA evaluates the reference on the CPU: each
        # product feeding a sum fused into one multiply-add, sin rounded
        # once from float64 (the same bits on the card and the CPU).
        p = _fma(d, torch.where(has_hit, t, 0.0)[:, None].expand_as(d), o)
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        tex = _fmac(0.18 * _sin(2.1 * x), _sin(2.7 * y), 0.5)
        tex = _fmac(0.14, _sin(_fmac(1.3, x, 5.3 * z)), tex)
        tex = _fmac(0.10, _sin(_fmac(11.0, y, 7.0 * z)), tex)
        diffuse = torch.clamp((normals * light).sum(dim=1), 0.0, 1.0)
        shade = torch.clamp(alb * tex * (0.45 + 0.55 * diffuse), 0.0, 1.0)
        out[s:s + chunk] = torch.where(has_hit, shade, 0.08)
    return out.cpu().numpy().reshape(F, N)


def simulate_sweep_batch(world, poses, n_rings, n_azimuth, elev_max_deg,
                         elev_min_deg, max_range, beam_elev=None,
                         az_start=0.0, *, device=None):
    """All F distorted scans of a drive, raycast on ``device``.

    poses: (F+1, 4, 4).  Returns raw (F, R*C) hit distances t (inf = miss)
    plus the sensor-frame unit directions (R*C, 3) shared by all frames.
    The caller applies noise/min-range/intensity exactly like the numpy
    path (:func:`finish_scan`).
    """
    from benchmarks.drive.fixtures import _interp_poses

    F = poses.shape[0] - 1
    if beam_elev is not None:
        elev = np.asarray(beam_elev, np.float64)
    else:
        elev = np.deg2rad(np.linspace(elev_max_deg, elev_min_deg, n_rings))
    phase = (np.arange(n_azimuth) + 0.5) / n_azimuth
    az_all = az_start - 2.0 * np.pi * phase
    ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
    ca, sa = np.cos(az_all)[None, :], np.sin(az_all)[None, :]
    dirs_s = np.stack([ce * ca, ce * sa,
                       np.broadcast_to(se, (n_rings, n_azimuth))], axis=-1)
    origins = np.empty((F, n_rings * n_azimuth, 3), np.float32)
    dirs_w = np.empty((F, n_rings * n_azimuth, 3), np.float32)
    for i in range(F):
        R_c, t_c = _interp_poses(poses[i], poses[i + 1], phase)
        dirs_w[i] = np.einsum("cij,rcj->rci", R_c, dirs_s).reshape(-1, 3)
        origins[i] = np.broadcast_to(
            t_c[None], (n_rings, n_azimuth, 3)).reshape(-1, 3)
    t = _sweep_hits(world.mins, world.maxs, origins, dirs_w, max_range,
                    device=device)
    return t, dirs_s.reshape(-1, 3).astype(np.float64)


def finish_scan(t, dirs_s, rng, noise_std, min_range=2.5, max_range=80.0):
    """Host tail of simulate_velodyne, bit-matching: noise draw order,
    range gating, intensity fill, min-range filter."""
    t = np.asarray(t, np.float64)
    if noise_std > 0 and rng is not None:
        t = t + rng.normal(0.0, noise_std, t.shape)
    ok = np.isfinite(t) & (t <= max_range) & (t >= min_range)
    t = np.where(ok, t, 0.0)
    p = dirs_s * t[:, None]
    flat = np.concatenate([p, 0.5 * np.ones_like(t[:, None])], axis=1)
    flat[~ok] = 0.0
    flat = flat.astype(np.float32)
    return flat[np.linalg.norm(flat[:, :3], axis=1) >= min_range]


def render_batch(world, T_w_cams, P, height, width, *, device=None):
    """All F camera frames, rendered on ``device`` -> (F, H, W) float32."""
    fx, fy = P[0, 0], P[1, 1]
    cx, cy = P[0, 2], P[1, 2]
    u, v = np.meshgrid(np.arange(width), np.arange(height))
    rays_c = np.stack([(u - cx) / fx, (v - cy) / fy,
                       np.ones_like(u, np.float64)], axis=-1).reshape(-1, 3)
    F = len(T_w_cams)
    origins = np.empty((F, rays_c.shape[0], 3), np.float32)
    dirs = np.empty((F, rays_c.shape[0], 3), np.float32)
    for i, T in enumerate(T_w_cams):
        rw = rays_c @ T[:3, :3].T
        rw /= np.linalg.norm(rw, axis=1, keepdims=True)
        dirs[i] = rw
        origins[i] = np.broadcast_to(T[:3, 3], rw.shape)
    shade = _render_frames(world, origins, dirs, world.albedo, device=device)
    return shade.reshape(F, height, width).astype(np.float32)
