"""Synthetic KITTI-like fixture generator (SURVEY.md §4.2).

No real KITTI data exists in this environment, so integration tests and the
benchmark run on simulated data with *exact* ground truth:

  * world  = a Manhattan scene of axis-aligned boxes (ground slab, building
    facades, poles/pillars) -> rich in both planar surfaces and vertical edges,
    exactly the structures LOAM features key on;
  * LiDAR  = raycast HDL-64E-style spinning scanner.  Crucially, the sensor
    pose is interpolated per azimuth column during the sweep, so raw scans
    exhibit true motion distortion and the deskew stage (C3) is testable
    against exact ground truth;
  * camera = pinhole render of the same boxes with a procedural world-anchored
    3D texture, so KLT tracking (C7) sees real, geometrically consistent
    structure, and LiDAR depth association (C8) is exact by construction.

KITTI frame conventions are respected: velodyne x-forward/y-left/z-up, camera
z-forward/x-right/y-down, ``Tr`` = velo->cam.

Frozen copy of ``velo_tpu_torch/io/fixtures.py`` for the benchmark, so
that no later change to the program can change the traffic.
:func:`make_fixture` simulates in numpy; given a ``device`` it raycasts
through :mod:`benchmarks.drive.accel` on it instead (the program's
``VELO_FIX_ACCEL=1`` path): the same slab algorithm in float32 torch.
``benchmarks/tests/test_bench_drive.py`` holds both equal to the
program's generator.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# World
# ---------------------------------------------------------------------------


@dataclass
class BoxWorld:
    """Axis-aligned boxes: mins (B,3), maxs (B,3), albedo (B,)."""

    mins: np.ndarray
    maxs: np.ndarray
    albedo: np.ndarray

    @property
    def n(self) -> int:
        return self.mins.shape[0]


def default_world(seed: int = 0) -> BoxWorld:
    """A street-canyon scene: ground, two building rows, pillars and crates."""
    rng = np.random.default_rng(seed)
    mins, maxs, albedo = [], [], []

    def add(mn, mx, a):
        mins.append(mn)
        maxs.append(mx)
        albedo.append(a)

    # Ground slab (z up, sensor at z=0, ground at -1.73 like KITTI).
    add([-50.0, -60.0, -2.5], [260.0, 60.0, -1.73], 0.55)
    # Building facades along the road (road runs along +x, width ~14 m).
    x = -20.0
    while x < 240.0:
        depth = rng.uniform(6.0, 14.0)
        h = rng.uniform(4.0, 12.0)
        gap = rng.uniform(2.0, 8.0)
        add([x, 7.0 + rng.uniform(0, 2.0), -1.73], [x + depth, 24.0, -1.73 + h],
            rng.uniform(0.35, 0.85))
        add([x, -24.0, -1.73], [x + depth, -7.0 - rng.uniform(0, 2.0), -1.73 + h],
            rng.uniform(0.35, 0.85))
        x += depth + gap
    # Poles / pillars near the road edge (strong edge features).
    for _ in range(30):
        px = rng.uniform(-10.0, 230.0)
        py = rng.uniform(4.5, 6.5) * rng.choice([-1.0, 1.0])
        r = rng.uniform(0.08, 0.2)
        h = rng.uniform(2.5, 6.0)
        add([px - r, py - r, -1.73], [px + r, py + r, -1.73 + h], rng.uniform(0.3, 0.9))
    # Scattered crates/cars (mid-height clutter).
    for _ in range(25):
        px = rng.uniform(0.0, 220.0)
        py = rng.uniform(-6.0, 6.0)
        sx, sy, sz = rng.uniform(1.0, 4.0, 3)
        add([px, py, -1.73], [px + sx, py + sy, -1.73 + sz * 0.6], rng.uniform(0.3, 0.9))

    return BoxWorld(
        np.asarray(mins, np.float64), np.asarray(maxs, np.float64),
        np.asarray(albedo, np.float64),
    )


def suburban_world(seed: int = 0) -> BoxWorld:
    """Held-out evaluation family (never used for tuning): an open suburban
    road.  Structurally different from :func:`default_world`'s dense street
    canyon on every axis the estimator is sensitive to:

      * the ground is TERRACED — 10 m slabs stepping up ~10 cm each (a ~1 %
        grade), so z/pitch are observable against real geometry instead of
        one infinite plane;
      * buildings are sparse, set far back (15-35 m), and frequently
        one-sided, with two fully open stretches (correspondence
        starvation on one side);
      * clutter is low fences/hedges (long thin boxes) rather than crates.
    """
    rng = np.random.default_rng(seed + 7919)  # decorrelate from default_world
    mins, maxs, albedo = [], [], []

    def add(mn, mx, a):
        mins.append(mn)
        maxs.append(mx)
        albedo.append(a)

    # Terraced rising ground: 10 m slabs, each ~10 cm higher.
    z = -1.73
    for i, x in enumerate(range(-50, 260, 10)):
        add([float(x), -60.0, -2.5], [float(x + 10), 60.0, z], 0.5)
        z += 0.1 * rng.uniform(0.6, 1.4)
    # Sparse set-back houses; two open stretches [60,95] and [150,185].
    x = -15.0
    while x < 240.0:
        w = rng.uniform(8.0, 14.0)
        gap = rng.uniform(12.0, 30.0)
        in_open = (60.0 < x < 95.0) or (150.0 < x < 185.0)
        gz = -1.73 + 0.1 * max(0.0, (x + 50.0) / 10.0)  # local terrace height
        if not in_open:
            side = rng.choice([-1.0, 1.0])
            setback = rng.uniform(15.0, 35.0)
            h = rng.uniform(3.0, 7.0)
            y0, y1 = setback, setback + rng.uniform(8.0, 12.0)
            if side < 0:
                y0, y1 = -y1, -y0
            add([x, y0, gz], [x + w, y1, gz + h], rng.uniform(0.35, 0.8))
            # Low fence/hedge at the lot edge (long thin box).
            fy = 6.0 * side
            add([x - 2.0, fy - 0.3, gz], [x + w + 2.0, fy + 0.3, gz + 1.0],
                rng.uniform(0.3, 0.6))
        x += w + gap
    # A few street poles (sparser than the canyon's 30).
    for _ in range(10):
        px = rng.uniform(-10.0, 230.0)
        py = rng.uniform(5.0, 8.0) * rng.choice([-1.0, 1.0])
        r = rng.uniform(0.08, 0.15)
        gz = -1.73 + 0.1 * max(0.0, (px + 50.0) / 10.0)
        add([px - r, py - r, gz], [px + r, py + r, gz + rng.uniform(3.0, 6.0)],
            rng.uniform(0.3, 0.9))
    return BoxWorld(
        np.asarray(mins, np.float64), np.asarray(maxs, np.float64),
        np.asarray(albedo, np.float64),
    )


def corridor_world(length: float = 300.0, half_width: float = 5.0,
                   wall_height: float = 6.0) -> BoxWorld:
    """A featureless straight corridor: ground + two long parallel walls.

    LiDAR's nightmare geometry — every surface normal is perpendicular to
    the direction of travel, so point-to-plane constraints say nothing about
    forward motion (and the walls' uniformity starves edge features).  The
    camera still sees the procedurally textured walls, making this the
    fixture where the "vision-enhanced" fusion must demonstrably win.
    """
    mins = [
        [-20.0, -half_width - 3.0, -2.5],  # ground
        [-20.0, half_width, -1.73],  # left wall
        [-20.0, -half_width - 1.0, -1.73],  # right wall
    ]
    maxs = [
        [length, half_width + 3.0, -1.73],
        [length, half_width + 1.0, -1.73 + wall_height],
        [length, -half_width, -1.73 + wall_height],
    ]
    albedo = [0.55, 0.6, 0.5]
    return BoxWorld(np.asarray(mins, np.float64),
                    np.asarray(maxs, np.float64),
                    np.asarray(albedo, np.float64))


def raycast(world: BoxWorld, origins: np.ndarray, dirs: np.ndarray,
            t_max: float = 1e4):
    """Batch ray/box intersection (slab method).

    origins, dirs: (R,3).  Returns (t, hit_idx, normals): nearest hit distance
    (inf if none), index of the hit box (-1), and outward surface normal.
    """
    o = origins[:, None, :]  # (R,1,3)
    d = dirs[:, None, :]
    inv_d = 1.0 / np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)[:, None, :]
    t1 = (world.mins[None] - o) * inv_d
    t2 = (world.maxs[None] - o) * inv_d
    tmin_ax = np.minimum(t1, t2)  # (R,B,3)
    tmax_ax = np.maximum(t1, t2)
    tmin = tmin_ax.max(axis=2)
    tmax = tmax_ax.min(axis=2)
    hit = (tmax >= tmin) & (tmax > 0) & (tmin < t_max)
    tmin = np.where(hit & (tmin > 1e-6), tmin, np.inf)
    t = tmin.min(axis=1)
    idx = np.where(np.isfinite(t), tmin.argmin(axis=1), -1)

    # Normal = axis achieving tmin on the winning box, sign against ray dir.
    r = np.arange(origins.shape[0])
    win = np.clip(idx, 0, None)
    ax = np.abs(tmin_ax[r, win] - t[:, None]) < 1e-9  # (R,3)
    # Break ties deterministically: first matching axis.
    ax_idx = np.argmax(ax, axis=1)
    normals = np.zeros_like(dirs)
    normals[r, ax_idx] = -np.sign(dirs[r, ax_idx])
    normals[idx < 0] = 0.0
    d = None  # noqa: F841
    return t, idx, normals


# ---------------------------------------------------------------------------
# Trajectory
# ---------------------------------------------------------------------------


def _euler_zyx(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll) (velodyne x-fwd/y-left/z-up)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    Ry = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    Rx = np.array([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]])
    return Rz @ Ry @ Rx


def make_trajectory(n_frames: int, dt: float = 0.1, speed: float = 8.0,
                    yaw_rate: float = 0.04, seed: int = 1,
                    wiggle_scale: float = 0.01,
                    pitch_amp: float = 0.0, roll_amp: float = 0.0,
                    z_amp: float = 0.0, grade: float = 0.0) -> np.ndarray:
    """(F,4,4) velodyne-frame world poses: forward arc with gentle yaw wiggle.

    ``pitch_amp``/``roll_amp`` (rad) and ``z_amp`` (m) add slow 6-DoF
    excitation — suspension rocking over bumps and road undulation — so
    LOAM's classic z/pitch drift modes (structurally invisible on planar,
    yaw-only trajectories, VERDICT r2 Missing#4) become testable.  Defaults
    of 0 reproduce the historical planar trajectories exactly.
    """
    rng = np.random.default_rng(seed)
    poses = np.zeros((n_frames, 4, 4))
    x, y, yaw = 0.0, 0.0, 0.0
    wiggle = rng.uniform(-1.0, 1.0, n_frames)
    pw = rng.uniform(-1.0, 1.0, n_frames)
    # A road grade (dz/dx) tilts the nose up and climbs z with travelled x
    # (suburban_world's terraced terrain rises ~1 %; the vehicle follows).
    base_pitch = -np.arctan(grade)  # velodyne y-left: +pitch noses DOWN
    for i in range(n_frames):
        # Smooth multi-period oscillations; incommensurate frequencies so
        # pitch/roll/z never phase-lock with the yaw wiggle.
        pitch = base_pitch + pitch_amp * (np.sin(0.21 * i) + 0.3 * pw[i])
        roll = roll_amp * np.sin(0.27 * i + 1.1)
        z = z_amp * np.sin(0.11 * i) + grade * x
        poses[i, :3, :3] = _euler_zyx(yaw, pitch, roll)
        poses[i, :3, 3] = [x, y, z]
        poses[i, 3, 3] = 1.0
        yaw += (yaw_rate * np.sin(0.15 * i) + wiggle_scale * wiggle[i]) * dt * 10
        x += speed * dt * np.cos(yaw)
        y += speed * dt * np.sin(yaw)
    return poses


# ---------------------------------------------------------------------------
# Sensors
# ---------------------------------------------------------------------------


def _interp_poses(T0: np.ndarray, T1: np.ndarray, s: np.ndarray):
    """Geodesic pose interpolation at fractions s (host, simulation only).

    Returns (R (S,3,3), t (S,3)). Vectorized so the scanner can use an exact
    per-azimuth-column pose — block-wise interpolation left ~cm sawtooth
    discontinuities in the synthetic scans that read as fake curvature.
    """
    from scipy.spatial.transform import Rotation, Slerp

    key = Rotation.from_matrix(np.stack([T0[:3, :3], T1[:3, :3]]))
    R = Slerp([0.0, 1.0], key)(np.asarray(s)).as_matrix()
    t = (1 - s[:, None]) * T0[:3, 3] + s[:, None] * T1[:3, 3]
    return R, t


def simulate_velodyne(
    world: BoxWorld,
    pose_start: np.ndarray,
    pose_end: np.ndarray,
    n_rings: int = 64,
    n_azimuth: int = 1024,
    elev_max_deg: float = 2.0,
    elev_min_deg: float = -24.8,
    max_range: float = 80.0,
    min_range: float = 2.5,
    azimuth_steps: int = 32,
    rng: Optional[np.random.Generator] = None,
    noise_std: float = 0.0,
    beam_elev: Optional[np.ndarray] = None,
    az_start: float = 0.0,
) -> np.ndarray:
    """One motion-distorted scan: float32 (n_rings * n_azimuth, 4).

    The sweep starts at azimuth 0 (sensor +x) and rotates clockwise (viewed
    from above, matching Velodyne).  The sensor pose advances from
    ``pose_start`` to ``pose_end`` over the sweep; each azimuth block is
    raycast from the interpolated pose, and returns are recorded in the
    *instantaneous* sensor frame — exactly how a raw KITTI .bin distorts.
    Points with no return get range 0 (KITTI drops them; we emit and filter).
    """
    # ``beam_elev`` overrides the uniform ladder with a real sensor table
    # (e.g. rangeimage.hdl64e_beam_elevations — two blocks of non-uniform
    # spacing); ``az_start`` rotates the sweep start (real KITTI starts
    # near the rear, ~pi) so the real-data conventions are exercisable on
    # synthetic drives.
    if beam_elev is not None:
        elev = np.asarray(beam_elev, np.float64)
        assert elev.shape == (n_rings,)
    else:
        elev = np.deg2rad(np.linspace(elev_max_deg, elev_min_deg, n_rings))
    phase = (np.arange(n_azimuth) + 0.5) / n_azimuth
    az_all = az_start - 2.0 * np.pi * phase  # clockwise from az_start

    # Exact per-column sensor pose (azimuth_steps kept for API compat).
    R_c, t_c = _interp_poses(pose_start, pose_end, phase)  # (C,3,3),(C,3)
    ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
    ca, sa = np.cos(az_all)[None, :], np.sin(az_all)[None, :]
    dirs_s = np.stack(
        [ce * ca, ce * sa, np.broadcast_to(se, (n_rings, n_azimuth))], axis=-1
    )  # (R, C, 3) sensor frame
    dirs_w = np.einsum("cij,rcj->rci", R_c, dirs_s).reshape(-1, 3)
    orig_w = np.broadcast_to(t_c[None], (n_rings, n_azimuth, 3)).reshape(-1, 3)

    # Chunked raycast: (rays x boxes x 3) intermediates get large at HDL-64
    # resolution; 32k-ray chunks keep peak memory modest.
    t = np.empty(dirs_w.shape[0])
    chunk = 32768
    for c0 in range(0, dirs_w.shape[0], chunk):
        c1 = min(c0 + chunk, dirs_w.shape[0])
        t[c0:c1] = raycast(world, orig_w[c0:c1], dirs_w[c0:c1],
                           t_max=max_range)[0]
    if noise_std > 0 and rng is not None:
        t = t + rng.normal(0.0, noise_std, t.shape)
    ok = np.isfinite(t) & (t <= max_range) & (t >= min_range)
    t = np.where(ok, t, 0.0)
    p = dirs_s.reshape(-1, 3) * t[:, None]
    flat = np.concatenate([p, 0.5 * np.ones_like(t[:, None])], axis=1)
    flat[~ok] = 0.0
    flat = flat.astype(np.float32)
    return flat[np.linalg.norm(flat[:, :3], axis=1) >= min_range]


def _procedural_shade(p: np.ndarray, albedo: np.ndarray, normal: np.ndarray) -> np.ndarray:
    """World-anchored texture so image intensity is a function of 3D position."""
    tex = (
        0.5
        + 0.18 * np.sin(2.1 * p[:, 0]) * np.sin(2.7 * p[:, 1])
        + 0.14 * np.sin(5.3 * p[:, 2] + 1.3 * p[:, 0])
        + 0.10 * np.sin(11.0 * p[:, 1] + 7.0 * p[:, 2])
    )
    light = np.array([0.4, 0.25, 0.88])
    diffuse = np.clip((normal * light).sum(1), 0.0, 1.0)
    return np.clip(albedo * tex * (0.45 + 0.55 * diffuse), 0.0, 1.0)


def render_camera(
    world: BoxWorld,
    T_w_cam: np.ndarray,
    P: np.ndarray,
    height: int,
    width: int,
) -> np.ndarray:
    """Pinhole render -> float32 (H, W) grayscale in [0,1]."""
    fx, fy = P[0, 0], P[1, 1]
    cx, cy = P[0, 2], P[1, 2]
    u, v = np.meshgrid(np.arange(width), np.arange(height))
    rays_c = np.stack(
        [(u - cx) / fx, (v - cy) / fy, np.ones_like(u, np.float64)], axis=-1
    ).reshape(-1, 3)
    rays_w = rays_c @ T_w_cam[:3, :3].T
    rays_w /= np.linalg.norm(rays_w, axis=1, keepdims=True)
    orig = np.broadcast_to(T_w_cam[:3, 3], rays_w.shape)
    t, idx, normals = raycast(world, orig, rays_w)
    hit = idx >= 0
    p = orig + rays_w * np.where(hit, t, 0.0)[:, None]
    shade = np.where(
        hit, _procedural_shade(p, world.albedo[np.clip(idx, 0, None)], normals), 0.08
    )
    return shade.reshape(height, width).astype(np.float32)


# ---------------------------------------------------------------------------
# Full fixture
# ---------------------------------------------------------------------------

# KITTI-like calibration for the synthetic camera (velo x-fwd/y-left/z-up ->
# cam z-fwd/x-right/y-down), camera 0.27 m above and 0.08 m ahead of velodyne.
def default_calib(height: int = 192, width: int = 640):
    T_cam_velo = np.array(
        [
            [0.0, -1.0, 0.0, 0.0],
            [0.0, 0.0, -1.0, -0.08],
            [1.0, 0.0, 0.0, -0.27],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )
    fx = 0.55 * width
    P = np.array(
        [[fx, 0.0, width / 2.0, 0.0], [0.0, fx, height / 2.0, 0.0],
         [0.0, 0.0, 1.0, 0.0]]
    )
    return P, T_cam_velo


@dataclass
class Fixture:
    scans: list  # list of (N_i, 4) float32 raw scans (motion-distorted)
    images: Optional[np.ndarray]  # (F, H, W) float32 or None
    gt_poses_velo: np.ndarray  # (F, 4, 4) world-from-velodyne
    gt_poses_cam: np.ndarray  # (F, 4, 4) world-from-cam0 (KITTI eval frame)
    P: np.ndarray
    T_cam_velo: np.ndarray
    times: np.ndarray = field(default=None)


def make_fixture(
    n_frames: int = 12,
    n_rings: int = 32,
    n_azimuth: int = 1024,
    height: int = 128,
    width: int = 384,
    with_images: bool = True,
    speed: float = 8.0,
    noise_std: float = 0.0,
    seed: int = 0,
    world: Optional[BoxWorld] = None,
    yaw_rate: float = 0.04,
    wiggle_scale: float = 0.01,
    pitch_amp: float = 0.0,
    roll_amp: float = 0.0,
    z_amp: float = 0.0,
    grade: float = 0.0,
    dropout: float = 0.0,
    beam_elev: Optional[np.ndarray] = None,
    az_start: float = 0.0,
    device=None,
) -> Fixture:
    """Simulate a short KITTI-like drive with exact ground truth.

    ``noise_std`` adds Gaussian range noise (real HDL-64E: ~2 cm);
    ``dropout`` randomly deletes that fraction of returns (dark/specular
    surfaces); ``pitch_amp``/``roll_amp``/``z_amp`` excite the non-planar
    DoF (see :func:`make_trajectory`).  ``device``: None simulates in
    numpy, a torch device raycasts there (:mod:`benchmarks.drive.accel`).
    """
    world = world if world is not None else default_world(seed)
    rng = np.random.default_rng(seed + 1)
    poses = make_trajectory(n_frames + 1, speed=speed, seed=seed + 2,
                            yaw_rate=yaw_rate, wiggle_scale=wiggle_scale,
                            pitch_amp=pitch_amp, roll_amp=roll_amp,
                            z_amp=z_amp, grade=grade)
    P, T_cam_velo = default_calib(height, width)

    # With a device: the slab raycasts in torch there (all scans, then all
    # images) instead of per-frame numpy: same algorithm in float32, same
    # host RNG consumption order (noise then dropout, per frame).
    accel = device is not None
    if accel:
        from benchmarks.drive import accel as fixtures_accel

        t_all, dirs_s = fixtures_accel.simulate_sweep_batch(
            world, poses[: n_frames + 1], n_rings, n_azimuth,
            elev_max_deg=2.0, elev_min_deg=-24.8, max_range=80.0,
            beam_elev=beam_elev, az_start=az_start, device=device)
        if with_images:
            T_w_cams = [poses[i] @ np.linalg.inv(T_cam_velo)
                        for i in range(n_frames)]
            imgs_all = fixtures_accel.render_batch(world, T_w_cams, P,
                                                   height, width,
                                                   device=device)

    scans, images = [], []
    for i in range(n_frames):
        if accel:
            scan = fixtures_accel.finish_scan(t_all[i], dirs_s, rng,
                                              noise_std)
        else:
            scan = simulate_velodyne(
                world, poses[i], poses[i + 1], n_rings=n_rings,
                n_azimuth=n_azimuth, rng=rng, noise_std=noise_std,
                beam_elev=beam_elev, az_start=az_start,
            )
        if dropout > 0:
            scan = scan[rng.uniform(size=len(scan)) >= dropout]
        scans.append(scan)
        if with_images:
            if accel:
                images.append(imgs_all[i])
            else:
                T_w_cam = poses[i] @ np.linalg.inv(T_cam_velo)
                images.append(render_camera(world, T_w_cam, P, height, width))

    gt_velo = poses[:n_frames]
    # KITTI evaluates in the cam0 frame of the first camera pose.
    T0 = gt_velo[0] @ np.linalg.inv(T_cam_velo)
    gt_cam = np.einsum(
        "ij,fjk,kl->fil", np.linalg.inv(T0), gt_velo, np.linalg.inv(T_cam_velo)
    )
    return Fixture(
        scans=scans,
        images=np.stack(images) if with_images else None,
        gt_poses_velo=gt_velo,
        gt_poses_cam=gt_cam,
        P=P,
        T_cam_velo=T_cam_velo,
        times=0.1 * np.arange(n_frames),
    )
