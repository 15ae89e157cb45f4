"""Long-fixture accuracy harness: drift on a 150+ frame synthetic drive
(port of the reference's ``scripts/longrun.py``).

Generates (and disk-caches) a long canyon drive with exact ground truth,
runs the odometry device-resident through ``odometry.run_scan`` (on the
card one CUDA-graph replay per frame) and prints the KITTI drift metric
for a set of named config variants, one JSON row per seed and variant, in
the reference's format (``scripts/summarize_runs.py`` reads both).

    python -m velo_tpu_torch.evaluation.longrun                  # the card
    python -m velo_tpu_torch.evaluation.longrun --device cpu --frames 8
    python -m velo_tpu_torch.evaluation.longrun --rings 64 --azimuth 2048 \\
        --prebin --seeds 0,1,2,3,4 --variants base,v:klt_impl=pallas

The numpy generator's cache file is the reference's
(``<cache-dir>/velo_longrun_{frames}_{rings}_{az}_{seed}{tag}.npz``, by
default in ``/tmp``), so both harnesses read one shared fixture.  Seeds
that are not cached yet are simulated in parallel, one spawned worker
process each.  With ``VELO_FIX_ACCEL=1`` the distorted drives are raycast
on the run's device instead (``io.fixtures_accel``), one after another in
this process, and cached as ``..._accel-torch-<device type>.npz``.
Without a card, and without ``--device cpu``, it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

import numpy as np

CACHE_DIR = "/tmp"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def accelerated(distorted=True) -> bool:
    """Whether :func:`get_fixture` raycasts on the device
    (``VELO_FIX_ACCEL=1``); the undistorted branch is always numpy, as in
    the reference."""
    return distorted and os.environ.get("VELO_FIX_ACCEL") == "1"


def generator(device=None, distorted=True) -> str:
    """The name of the drive simulator :func:`get_fixture` runs: "numpy",
    or "accel-torch-<device type>" with ``VELO_FIX_ACCEL=1``.  The
    reference names its own "accel-<JAX backend>"; the two never share a
    cache file."""
    if not accelerated(distorted):
        return "numpy"
    from velo_tpu_torch.pipeline.odometry import resolve_device

    return f"accel-torch-{resolve_device(device).type}"


def fixture_path(frames, rings, az, seed=0, distorted=True,
                 with_images=False, noise_std=0.0, dropout=0.0,
                 sixdof=False, world="canyon", cache_dir=CACHE_DIR,
                 device=None) -> str:
    """The cache file of :func:`get_fixture`: the reference's name for
    the numpy generator, tagged with the generator otherwise (the
    accelerated raycast matches numpy only to float32 tolerance, and 150
    frames of odometry amplify that into drift differences of
    1-2 %/100 m: one must never be read as the other)."""
    tag = ("" if distorted else "_nodist") + ("_img" if with_images else "")
    if noise_std:
        tag += f"_n{noise_std:g}"
    if dropout:
        tag += f"_d{dropout:g}"
    if sixdof:
        tag += "_6dof"
    if world != "canyon":
        tag += f"_{world}"
    if accelerated(distorted):
        tag += f"_{generator(device)}"
    return os.path.join(cache_dir,
                        f"velo_longrun_{frames}_{rings}_{az}_{seed}{tag}.npz")


def get_fixture(frames, rings, az, seed=0, distorted=True,
                with_images=False, noise_std=0.0, dropout=0.0,
                sixdof=False, world="canyon", cache_dir=CACHE_DIR,
                device=None):
    """(scans, masks, gt_velo, gt_cam, T_cam_velo, images or None, P or
    None) of a simulated drive, padded to ``rings * az`` points: loaded
    from the cache file when it exists, else simulated and cached.
    ``device``: where ``VELO_FIX_ACCEL=1`` raycasts (default: the card)."""
    from velo_tpu_torch.io import fixtures, kitti

    cache = fixture_path(frames, rings, az, seed, distorted, with_images,
                         noise_std, dropout, sixdof, world, cache_dir,
                         device)
    # Bumpy-road excitation: ~1.7deg pitch, ~1.1deg roll, 6cm z bobbing.
    sixdof_kw = (dict(pitch_amp=0.03, roll_amp=0.02, z_amp=0.06)
                 if sixdof else {})
    if world == "suburban":
        # Held-out family: open terraced suburb, trajectory climbs the ~1%
        # grade with the terrain (fixtures.suburban_world).
        sixdof_kw.update(world=fixtures.suburban_world(seed), grade=0.01)
    n_max = rings * az
    if os.path.exists(cache):
        d = np.load(cache)
        return (d["scans"], d["masks"], d["gt_velo"], d["gt_cam"],
                d["T_cam_velo"],
                d["images"] if with_images else None,
                d["P"] if "P" in d else None)
    print(f"simulating {frames} frames at {rings}x{az}…", file=sys.stderr)
    t0 = time.perf_counter()
    if distorted:
        fx = fixtures.make_fixture(n_frames=frames, n_rings=rings,
                                   n_azimuth=az, with_images=with_images,
                                   height=128, width=384,
                                   speed=8.0, seed=seed,
                                   noise_std=noise_std, dropout=dropout,
                                   device=device, **sixdof_kw)
        raw, gt_velo, gt_cam, T_cv = (fx.scans, fx.gt_poses_velo,
                                      fx.gt_poses_cam, fx.T_cam_velo)
    else:
        # Undistorted oracle branch: split sixdof_kw into world/trajectory
        # pieces (make_trajectory doesn't take a world).
        box_world = sixdof_kw.pop("world", None) or fixtures.default_world(seed)
        rng = np.random.default_rng(seed + 1)
        poses = fixtures.make_trajectory(frames + 1, speed=8.0, seed=seed + 2,
                                         **sixdof_kw)
        raw = [fixtures.simulate_velodyne(box_world, poses[i], poses[i],
                                          n_rings=rings, n_azimuth=az,
                                          rng=rng) for i in range(frames)]
        _, T_cv = fixtures.default_calib(128, 384)
        gt_velo = poses[:frames]
        T0 = gt_velo[0] @ np.linalg.inv(T_cv)
        gt_cam = np.einsum("ij,fjk,kl->fil", np.linalg.inv(T0), gt_velo,
                           np.linalg.inv(T_cv))
    t_sim = time.perf_counter() - t0
    padded = [kitti.pad_scan(s, n_max) for s in raw]
    scans = np.stack([p[0] for p in padded])
    masks = np.stack([p[1] for p in padded])
    extra = ({"images": fx.images, "P": fx.P}
             if with_images and distorted else {})
    # Written under another name and renamed, so that a harness reading
    # the same cache meanwhile never sees half a file.
    os.makedirs(cache_dir, exist_ok=True)
    part = f"{cache[:-len('.npz')]}.{os.getpid()}.part.npz"
    np.savez_compressed(part, scans=scans, masks=masks,
                        gt_velo=gt_velo, gt_cam=gt_cam, T_cam_velo=T_cv,
                        **extra)
    os.replace(part, cache)
    secs = time.perf_counter() - t0
    print(f"simulated {os.path.basename(cache)} with "
          f"{generator(device, distorted)} in {secs:.2f} s: {t_sim:.2f} s "
          f"simulating, {secs - t_sim:.2f} s padding and writing",
          file=sys.stderr)
    return (scans, masks, gt_velo, gt_cam, T_cv,
            extra.get("images"), extra.get("P"))


def _cache_fixture(kw) -> str:
    """Simulate and cache one drive, in a worker of :func:`simulate`."""
    get_fixture(**kw)
    return fixture_path(**kw)


def simulate(kws) -> None:
    """Cache the drives of :func:`get_fixture` keyword sets ``kws`` that
    are not cached yet: one spawned worker process each (at most one per
    core), since one 150-frame 64 x 2048 drive takes minutes on a core.
    The arrays do not depend on the process that simulates them.  Drives
    raycast on the device (``VELO_FIX_ACCEL=1``) are left to
    :func:`get_fixture` in this process: a worker would make a CUDA
    context of its own."""
    todo = [kw for kw in kws if not accelerated(kw.get("distorted", True))
            and not os.path.exists(fixture_path(**kw))]
    if len(todo) < 2:
        return
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            max_workers=min(len(todo), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        for fut in [pool.submit(_cache_fixture, kw) for kw in todo]:
            fut.result()


def fixture_digest(scans, masks) -> str:
    """sha256 of a drive's padded scans and masks: two machines' rows are
    comparable only when their fixtures are equal (numpy's vectorised
    trigonometry may differ between CPUs)."""
    h = hashlib.sha256()
    for a in (scans, masks):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def variant_cfg(name, rings, az):
    """The named variant's LiDAR-only config at ``rings`` x ``az``:
    ``base``, ``edges3``, ``tm4``, ``sectors6``, ``planars6``, or a field
    override ``s:`` / ``l:`` / ``m:`` (``"s:lm_iters=6+huber_delta_icp=0.2"``);
    a ``v:`` override is applied by :func:`run_config` once the vision
    config is in place."""
    from velo_tpu_torch.config import LidarConfig, VeloConfig, apply_overrides

    lid = dict(n_rings=rings, n_azimuth=az)
    named = {"base": {}, "edges3": dict(edges_per_sector=3),
             "tm4": dict(target_mult=4), "sectors6": dict(n_sectors=6),
             "planars6": dict(planars_per_sector=6)}
    if name in named:
        lid.update(named[name])
    elif name[:2] not in ("s:", "l:", "m:", "v:"):
        raise SystemExit(f"unknown variant {name}")
    cfg = VeloConfig(lidar=LidarConfig(**lid), use_vision=False,
                     use_map=True, n_max_points=rings * az)
    if name[:2] in ("s:", "l:", "m:"):
        cfg = apply_overrides(cfg, name)
    return cfg


def run_config(name, rings, az, prebin=False, nodistort=False,
               vision=False):
    """:func:`variant_cfg` with the run's flags: ``--prebin`` (host
    pre-binned grids), ``--nodistort`` (deskew off) and ``--vision`` (the
    fused pipeline, 128 x 384 images, 128 tracks, then the ``v:``
    override)."""
    from velo_tpu_torch.config import VisionConfig, apply_overrides

    cfg = variant_cfg(name, rings, az)
    if prebin:
        cfg = dataclasses.replace(cfg, prebin_host=True)
    if nodistort:
        cfg = dataclasses.replace(cfg, use_deskew=False)
    if vision:
        cfg = dataclasses.replace(
            cfg, use_vision=True,
            vision=VisionConfig(height=128, width=384, k_tracks=128,
                                grid_cols=24))
        if name[:2] == "v:":
            cfg = apply_overrides(cfg, name)
    return cfg


def prebin(scans, masks, lidar_cfg):
    """Padded raw scans -> host pre-binned (F, R, W, 5) grids and (F, R, W)
    masks (``rangeimage.bin_scan_host``, the production layout)."""
    from velo_tpu_torch.lidar import rangeimage as ri_mod

    binned = [ri_mod.bin_scan_host(s[m], lidar_cfg)
              for s, m in zip(scans, masks)]
    return (np.stack([b[0] for b in binned]),
            np.stack([b[1] for b in binned]))


def run_drive(cfg, scans_d, masks_d, images_d=None, cam=None):
    """One cold ``odometry.run_scan`` over the whole drive (tensors on the
    run's device), timed as the reference times its jitted scan: graphs
    captured afresh, so the seconds include the captures as the
    reference's include its compile, ending in ``torch.cuda.synchronize()``
    on the card.  Returns (final carry, stacked FrameResult, seconds)."""
    import torch

    from velo_tpu_torch.pipeline import graphs, odometry

    dev = scans_d.device
    graphs.release()
    carry = odometry.init_carry(cfg, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    carry, out = odometry.run_scan(carry, scans_d, masks_d, cfg,
                                   images=images_d, cam=cam)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return carry, out, time.perf_counter() - t0


def metrics_row(variant, seed, poses_velo, gt_velo, gt_cam, T_cam_velo,
                degenerate, secs):
    """The reference's row of one run -> (row, per-frame relative
    translation error (m), per-frame relative rotation error (deg))."""
    from velo_tpu_torch.evaluation import kitti_metric
    from velo_tpu_torch.pipeline import odometry

    poses_cam = odometry.velo_to_cam_trajectory(poses_velo, T_cam_velo)
    errs = kitti_metric.evaluate_trajectory(poses_cam, gt_cam)
    ate = kitti_metric.ate_rmse(poses_cam, gt_cam)
    F = len(poses_velo)
    rel_gt = np.asarray(
        [np.linalg.inv(gt_velo[i - 1]) @ gt_velo[i] for i in range(1, F)])
    rel_est = np.asarray(
        [np.linalg.inv(poses_velo[i - 1]) @ poses_velo[i]
         for i in range(1, F)])
    rel_err = np.asarray([np.linalg.inv(a) @ b
                          for a, b in zip(rel_gt, rel_est)])
    rel = np.linalg.norm(rel_err[:, :3, 3], axis=1)
    # per-frame rotation error angle (deg)
    tr = np.clip((np.trace(rel_err[:, :3, :3], axis1=1, axis2=2) - 1) / 2,
                 -1, 1)
    rot = np.degrees(np.arccos(tr))
    return dict(
        variant=variant, seed=seed,
        t_err_pct=round(float(errs.t_err_pct), 3),
        r_err_deg=round(float(errs.r_err_deg_per_100m), 3),
        ate_m=round(float(ate), 3),
        med_rel_err_m=round(float(np.median(rel)), 4),
        max_rel_err_m=round(float(rel.max()), 3),
        med_rot_err_deg=round(float(np.median(rot)), 4),
        worst_frame=int(np.argmax(rel)) + 1,
        degenerate=int(np.asarray(degenerate)[1:].sum()),
        secs=round(secs, 1),
        frames_per_s=round(F / secs, 3)), rel, rot


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m velo_tpu_torch.evaluation.longrun",
        description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--rings", type=int, default=32)
    ap.add_argument("--azimuth", type=int, default=1024)
    ap.add_argument("--variants", default="base")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--dump", default=None,
                    help="write per-frame diagnostics .npz here")
    ap.add_argument("--nodistort", action="store_true",
                    help="undistorted scans + deskew off (oracle ceiling); "
                    "always simulated with numpy, VELO_FIX_ACCEL or not")
    ap.add_argument("--vision", action="store_true",
                    help="fused pipeline (config 4) with rendered images")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="Gaussian range noise std in meters (real ~0.02)")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="fraction of returns randomly dropped")
    ap.add_argument("--sixdof", action="store_true",
                    help="non-planar trajectory (pitch/roll/z excitation)")
    ap.add_argument("--prebin", action="store_true",
                    help="host-pre-binned grid input (production layout)")
    ap.add_argument("--smooth", action="store_true",
                    help="also report the non-causal smoother's refinement")
    ap.add_argument("--smooth-window", type=int, default=8)
    ap.add_argument("--smooth-passes", type=int, default=2)
    ap.add_argument("--world", default="canyon",
                    choices=("canyon", "suburban"),
                    help="world family (suburban = held-out terraced suburb)")
    ap.add_argument("--trail", default=None,
                    help="append result rows + run metadata (git sha, "
                    "device, fixture digest) to this JSONL file")
    ap.add_argument("--cache-dir", default=CACHE_DIR,
                    help="where simulated drives are cached (default /tmp, "
                    "the reference harness's cache)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                    "one unless 'cpu' is given); with VELO_FIX_ACCEL=1 "
                    "the drives are also raycast there")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from velo_tpu_torch.geom import camera as cam_mod
    from velo_tpu_torch.pipeline import odometry

    dev = odometry.resolve_device(args.device)
    seeds = [int(s) for s in args.seeds.split(",")]
    fixture_kw = dict(frames=args.frames, rings=args.rings, az=args.azimuth,
                      distorted=not args.nodistort, with_images=args.vision,
                      noise_std=args.noise, dropout=args.dropout,
                      sixdof=args.sixdof, world=args.world,
                      cache_dir=args.cache_dir, device=dev)
    simulate([dict(fixture_kw, seed=s) for s in seeds])

    trail_meta = None
    if args.trail:
        import subprocess

        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=_REPO).stdout.strip()
        trail_meta = dict(
            sha=sha or "unknown",
            frames=args.frames, rings=args.rings, azimuth=args.azimuth,
            world=args.world, sixdof=args.sixdof, vision=args.vision,
            noise=args.noise, dropout=args.dropout, prebin=args.prebin,
            generator=generator(dev, not args.nodistort),
            platform=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else dev.type),
            ts=time.strftime("%Y-%m-%dT%H:%M:%S"),
        )

    rows = []
    for seed in seeds:
        scans, masks, gt_velo, gt_cam, T_cam_velo, images, P = get_fixture(
            seed=seed, **fixture_kw)
        digest = fixture_digest(scans, masks)
        if args.prebin:
            from velo_tpu_torch.config import LidarConfig

            scans, masks = prebin(scans, masks, LidarConfig(
                n_rings=args.rings, n_azimuth=args.azimuth))
        scans_d = torch.as_tensor(scans).to(dev)
        masks_d = torch.as_tensor(masks).to(dev)
        images_d = (torch.as_tensor(np.asarray(images, np.float32)).to(dev)
                    if args.vision else None)
        cam = (cam_mod.from_numpy(P, T_cam_velo, 384, 128, dev)
               if args.vision else None)

        for name in args.variants.split(","):
            cfg = run_config(name, args.rings, args.azimuth,
                             prebin=args.prebin, nodistort=args.nodistort,
                             vision=args.vision)
            _, out, dt = run_drive(cfg, scans_d, masks_d, images_d, cam)
            poses_velo = out.T_w.cpu().numpy()
            degenerate = out.degenerate.cpu().numpy()
            row, rel, rot = metrics_row(name, seed, poses_velo, gt_velo,
                                        gt_cam, T_cam_velo, degenerate, dt)
            rows.append(row)
            print(json.dumps(row), flush=True)
            if trail_meta is not None:
                with open(args.trail, "a") as f:
                    f.write(json.dumps(dict(row, **trail_meta,
                                            fixture_sha256=digest)) + "\n")
            if args.smooth:
                from velo_tpu_torch.pipeline import smoother

                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                refined = smoother.smooth_trajectory(
                    scans, masks, poses_velo, cfg,
                    window=args.smooth_window, passes=args.smooth_passes,
                    device=dev)
                srow, _, _ = metrics_row(name + "+smooth", seed, refined,
                                         gt_velo, gt_cam, T_cam_velo,
                                         degenerate,
                                         time.perf_counter() - t0)
                rows.append(srow)
                print(json.dumps(srow), flush=True)
            if args.dump:
                # Every FrameResult diagnostic (lm_accept, gate/prior/map
                # activation flags, depth-track survivors, trust ramp, ...)
                # rides along so episode analysis needs only this dump.
                diag = {k: getattr(out, k).cpu().numpy()
                        for k in type(out)._fields if k != "T_w"}
                np.savez_compressed(
                    f"{args.dump}_{name.replace(':', '_')}_s{seed}.npz",
                    rel=rel, rot=rot, poses_velo=poses_velo, gt_velo=gt_velo,
                    **diag)
    return rows


if __name__ == "__main__":
    main()
