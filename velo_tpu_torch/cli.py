"""The command line: run odometry, write KITTI poses, evaluate
(port of ``velo_tpu/cli.py``).

  velo-tpu-torch --synthetic --frames 20 --out out/           # simulated drive
  velo-tpu-torch --kitti-root /data/kitti --seq 00 --out out/ # KITTI sequence
  velo-tpu-torch --synthetic --batch 8 --out out/  # 8 drives, one program

Writes ``<out>/<seq>.txt`` in KITTI 3x4 row-major format and, when ground
truth is available, prints the official drift metric.  Runs on the card
unless ``--device cpu`` is given; without a card and without that flag it
raises.  With ``VELO_FIX_ACCEL=1`` a ``--synthetic`` drive (or batch) is
raycast on the run's device (``io.fixtures_accel``) instead of by the
numpy simulator.  ``python -m velo_tpu_torch.io.fake_kitti --out DIR``
exports a simulated drive in the KITTI layout for ``--kitti-root DIR``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np

def build_parser():
    p = argparse.ArgumentParser(prog="velo-tpu-torch", description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--synthetic", action="store_true",
                     help="run on a simulated KITTI-like drive")
    src.add_argument("--kitti-root", help="KITTI odometry dataset root")
    p.add_argument("--seq", default="00", help="sequence id (KITTI mode)")
    p.add_argument("--frames", type=int, default=20,
                   help="frame count (synthetic) or limit (KITTI, 0=all)")
    p.add_argument("--out", default="out", help="output directory")
    p.add_argument("--no-vision", action="store_true",
                   help="LiDAR-only pipeline (configs 1-2)")
    p.add_argument("--no-map", action="store_true",
                   help="disable scan-to-map refinement (config 1)")
    p.add_argument("--no-deskew", action="store_true")
    p.add_argument("--no-prebin", action="store_true",
                   help="feed raw (N,4) scans and bin on device instead of "
                        "the host-pre-binned production layout")
    p.add_argument("--rings", type=int, default=None,
                   help="override ring count (synthetic default 32)")
    p.add_argument("--world", default="canyon",
                   choices=("canyon", "suburban", "corridor"),
                   help="synthetic world family: street canyon (default), "
                        "held-out terraced suburb, degenerate corridor")
    p.add_argument("--seed", type=int, default=0,
                   help="synthetic world/trajectory seed")
    p.add_argument("--azimuth", type=int, default=None)
    p.add_argument("--json", action="store_true",
                   help="print a machine-readable result line")
    p.add_argument("--checkpoint", default=None,
                   help="carry checkpoint file (crash recovery)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="dump the odometry carry every N frames")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint, skipping done frames")
    p.add_argument("--plot", action="store_true",
                   help="write trajectory + drift plots next to the poses")
    p.add_argument("--smooth", action="store_true",
                   help="non-causal pass: refine the trajectory against "
                        "windowed multi-frame maps (offline/batch eval; "
                        "holds all scans in device memory)")
    p.add_argument("--smooth-window", type=int, default=8,
                   help="smoother half-window in frames")
    p.add_argument("--smooth-passes", type=int, default=2)
    p.add_argument("--batch", type=int, default=0,
                   help="config 5: run N synthetic sequences as one batched "
                        "program (torch.func.vmap over the step)")
    p.add_argument("--shard", action="store_true",
                   help="shard the --batch dimension over all local cards")
    p.add_argument("--set", dest="set_spec", default=None, metavar="SPEC",
                   help="config field overrides, shared syntax: "
                        "\"s:lm_iters=4,v:klt_iters_fb=2\" (s=solver, "
                        "v=vision, l=lidar, m=map; see config.apply_overrides)")
    p.add_argument("--fast", action="store_true",
                   help="throughput preset (config.FAST_PRESET): "
                        "deferred-tail obs-prior LM; applied before --set")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the card; the "
                        "run fails without one unless this says cpu)")
    return p


def _apply_cli_overrides(cfg, args):
    """--fast preset first, then explicit --set fields (so --set wins)."""
    from velo_tpu_torch.config import FAST_PRESET, apply_overrides

    if args.fast:
        cfg = apply_overrides(cfg, FAST_PRESET)
    if args.set_spec:
        cfg = apply_overrides(cfg, args.set_spec)
    return cfg


class BatchInputs(NamedTuple):
    """What ``--batch`` runs: B simulated drives at the batch mode's
    configuration, stacked along a leading batch axis."""
    cfg: object  # VeloConfig
    scans: np.ndarray  # (B, F, R, W, 5) grids, or (B, F, N_MAX, 4) raw
    masks: np.ndarray  # (B, F, R, W) or (B, F, N_MAX)
    images: np.ndarray | None  # (B, F, H, W) float32 with vision
    cam: object  # the shared Camera with vision, else None
    gts: list  # per sequence, (F, 4, 4) ground truth in the cam0 frame
    tcvs: list  # per sequence, T_cam_velo


def batch_inputs(args, device) -> BatchInputs:
    """Simulate the ``--batch`` sequences: seeds 100 + b, the reference's
    configuration (``rings or 32`` x ``azimuth or 1024``, 128 x 384
    images, 128 tracks in 24 grid columns)."""
    from velo_tpu_torch.config import LidarConfig, VeloConfig, VisionConfig
    from velo_tpu_torch.geom import camera as cam_mod
    from velo_tpu_torch.io import fixtures, kitti
    from velo_tpu_torch.lidar import rangeimage as ri_mod
    from velo_tpu_torch.pipeline import odometry

    use_vision = not args.no_vision
    rings = args.rings or 32
    az = args.azimuth or 1024
    h, w = 128, 384
    cfg = VeloConfig(
        lidar=LidarConfig(n_rings=rings, n_azimuth=az),
        vision=VisionConfig(height=h, width=w, k_tracks=128, grid_cols=24),
        use_vision=use_vision,
        use_map=not args.no_map,
        use_deskew=not args.no_deskew,
        n_max_points=rings * az,
        # Same production default as single-sequence mode: frames arrive as
        # host-pre-binned (R, W, 5) grids (the bench/loader layout).
        prebin_host=not args.no_prebin,
    )
    cfg = _apply_cli_overrides(cfg, args)
    odometry.check_slice(cfg)
    print(f"simulating {args.batch} sequences x {args.frames} frames…",
          file=sys.stderr)

    def _lidar_frame(s):
        if cfg.prebin_host:
            return ri_mod.bin_scan_host(s, cfg.lidar)
        return kitti.pad_scan(s, cfg.n_max_points)

    scans, masks, gts, tcvs, images = [], [], [], [], []
    cam = None
    for b in range(args.batch):
        fx = fixtures.make_fixture(n_frames=args.frames, n_rings=rings,
                                   n_azimuth=az, with_images=use_vision,
                                   height=h, width=w, seed=100 + b,
                                   device=device)
        padded = [_lidar_frame(s) for s in fx.scans]
        scans.append(np.stack([p[0] for p in padded]))
        masks.append(np.stack([p[1] for p in padded]))
        gts.append(fx.gt_poses_cam)
        tcvs.append(fx.T_cam_velo)
        if use_vision:
            images.append(fx.images)
            if cam is None:  # shared calibration across synthetic sequences
                cam = cam_mod.from_numpy(fx.P, fx.T_cam_velo, w, h, device)
    return BatchInputs(cfg, np.stack(scans), np.stack(masks),
                       np.stack(images) if use_vision else None, cam, gts,
                       tcvs)


def run_batch_mode(args):
    """Config 5 on the command line: N independent synthetic sequences,
    one program.

    Honors --no-vision like single-sequence mode: by default each sequence
    runs the fused (config-4) pipeline with rendered images.
    """
    from velo_tpu_torch.evaluation import kitti_metric
    from velo_tpu_torch.io import kitti
    from velo_tpu_torch.pipeline import batch as batch_mod
    from velo_tpu_torch.pipeline import odometry

    device = odometry.resolve_device(args.device)
    bi = batch_inputs(args, device)
    t0 = time.perf_counter()
    poses, diag = batch_mod.run_sequences(bi.scans, bi.masks, bi.cfg,
                                          shard=args.shard, images=bi.images,
                                          cam=bi.cam, device=device)
    dt = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    rows = []
    for b in range(args.batch):
        cam_traj = odometry.velo_to_cam_trajectory(poses[b], bi.tcvs[b])
        kitti.write_poses(os.path.join(args.out, f"seq{b:02d}.txt"),
                          cam_traj)
        ate = kitti_metric.ate_rmse(cam_traj, bi.gts[b])
        errs = kitti_metric.evaluate_trajectory(cam_traj, bi.gts[b])
        rows.append({
            "seq": b, "ate_rmse_m": round(float(ate), 4),
            # Both halves of the north-star metric: trans %/100m AND rot
            # deg/100m.
            "t_err_pct": (round(float(errs.t_err_pct), 3)
                          if errs.n_segments else None),
            "r_err_deg_per_100m": (round(float(errs.r_err_deg_per_100m), 4)
                                   if errs.n_segments else None),
        })
    total_fps = args.batch * args.frames / dt
    result = {"batch": args.batch, "frames": args.frames,
              "agg_fps": round(total_fps, 2),
              "sharded": bool(args.shard), "prebin": bi.cfg.prebin_host,
              "sequences": rows}
    print(json.dumps(result))
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.batch:
        return run_batch_mode(args)
    if args.plot:
        # Fail before any frame runs, not after the whole sequence.
        import matplotlib  # noqa: F401

    from velo_tpu_torch.config import LidarConfig, VeloConfig, VisionConfig
    from velo_tpu_torch.evaluation import kitti_metric
    from velo_tpu_torch.geom import camera as cam_mod
    from velo_tpu_torch.io import fixtures, kitti
    from velo_tpu_torch.lidar import rangeimage as ri_mod
    from velo_tpu_torch.pipeline import odometry

    device = odometry.resolve_device(args.device)
    use_vision = not args.no_vision
    img_pf = None

    if args.synthetic:
        rings = args.rings or 32
        az = args.azimuth or 1024
        h, w = 128, 384
        cfg = VeloConfig(
            lidar=LidarConfig(n_rings=rings, n_azimuth=az),
            vision=VisionConfig(height=h, width=w, k_tracks=128,
                                grid_cols=24),
            n_max_points=rings * az,
            use_vision=use_vision,
            use_map=not args.no_map,
            use_deskew=not args.no_deskew,
            prebin_host=not args.no_prebin,
        )
        cfg = _apply_cli_overrides(cfg, args)
        odometry.check_slice(cfg)
        print(f"simulating {args.frames} frames…", file=sys.stderr)
        world_kw = {}
        if args.world == "suburban":
            world_kw = dict(world=fixtures.suburban_world(args.seed),
                            grade=0.01)
        elif args.world == "corridor":
            world_kw = dict(world=fixtures.corridor_world(), yaw_rate=0.0,
                            wiggle_scale=0.0)
        fx = fixtures.make_fixture(
            n_frames=args.frames, n_rings=rings, n_azimuth=az, height=h,
            width=w, with_images=use_vision, seed=args.seed, device=device,
            **world_kw)
        cam = cam_mod.from_numpy(fx.P, fx.T_cam_velo, w, h,
                                 device) if use_vision else None

        def _lidar_frame(s):
            if cfg.prebin_host:
                return ri_mod.bin_scan_host(s, cfg.lidar)
            return kitti.pad_scan(s, cfg.n_max_points)

        frames = [
            _lidar_frame(s) + ((fx.images[i],) if use_vision else ())
            for i, s in enumerate(fx.scans)
        ]
        gt_cam = fx.gt_poses_cam
        T_cam_velo = fx.T_cam_velo
        seq_name = "synthetic"
    else:
        cfg = VeloConfig(
            # Real HDL-64E conventions: non-uniform beam table for ring
            # assignment, sweep start at the rear (~pi azimuth).
            lidar=LidarConfig(ring_mode="hdl64e", az_start=float(np.pi)),
            use_vision=use_vision,
            use_map=not args.no_map,
            use_deskew=not args.no_deskew,
            prebin_host=not args.no_prebin,
        )
        cfg = _apply_cli_overrides(cfg, args)
        odometry.check_slice(cfg)
        seq = kitti.KittiSequence(args.kitti_root, args.seq,
                                  cfg.n_max_points)
        n = seq.n_frames if args.frames == 0 else min(args.frames,
                                                      seq.n_frames)
        T_cam_velo = seq.calib["Tr"]
        cam = cam_mod.from_numpy(
            seq.calib["P0"], T_cam_velo, cfg.vision.width,
            cfg.vision.height, device) if use_vision else None

        # Image decode off the critical path: threaded read-ahead.
        img_pf = kitti.ImagePrefetcher(seq.image, n) if use_vision else None

        def gen():
            # The native prefetch loader first (pre-binning in its C++
            # workers with prebin_host); the synchronous Python reader when
            # the library cannot be built or finds no scans.
            def _emit(scan, mask, i):
                if cfg.prebin_host:
                    scan, mask = ri_mod.bin_scan_host(scan[mask], cfg.lidar)
                return (scan, mask, img_pf.get(i)) if use_vision else (
                    scan, mask)

            from velo_tpu_torch.io import native_loader

            try:
                if cfg.prebin_host:
                    loader = native_loader.NativeBinnedScanLoader(
                        seq.velo_dir, cfg.lidar, n_max=cfg.n_max_points)
                    reader = "native-binned"
                else:
                    loader = native_loader.NativeScanLoader(
                        seq.velo_dir, cfg.n_max_points)
                    reader = "native"
            except (RuntimeError, FileNotFoundError):
                loader, reader = None, "python"
            print(f"scan reader: {reader}", file=sys.stderr)
            if loader is None:
                for i in range(n):
                    yield _emit(*seq.scan(i), i)
                return
            try:
                for i, (scan, mask) in enumerate(loader):
                    if i >= n:
                        break
                    if reader == "native-binned":
                        yield ((scan, mask, img_pf.get(i)) if use_vision
                               else (scan, mask))
                    else:
                        yield _emit(scan, mask, i)
            finally:
                loader.close()

        frames = gen()
        gt_cam = seq.gt_poses[:n] if seq.gt_poses is not None else None
        seq_name = args.seq

    try:
        if args.smooth:
            # The smoother re-solves every frame against windowed
            # multi-frame maps, so it needs the whole scan stack (not the
            # streaming generator).  Materialize once; both passes consume
            # the list.
            frames = list(frames)

        t0 = time.perf_counter()
        poses_velo, diag = odometry.run_sequence_host(
            frames, cfg, cam=cam, checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every, resume=args.resume,
            device=device)
        dt = time.perf_counter() - t0
    finally:
        if img_pf is not None:
            img_pf.close()
    fps = len(poses_velo) / dt

    fwd_errs = None
    smooth_s = None
    if args.smooth:
        from velo_tpu_torch.pipeline import smoother

        if gt_cam is not None:
            fwd_errs = kitti_metric.evaluate_trajectory(
                odometry.velo_to_cam_trajectory(poses_velo, T_cam_velo),
                gt_cam)
        scans_all = np.stack([f[0] for f in frames])
        masks_all = np.stack([f[1] for f in frames])
        t0 = time.perf_counter()
        poses_velo = smoother.smooth_trajectory(
            scans_all, masks_all, poses_velo, cfg,
            window=args.smooth_window, passes=args.smooth_passes,
            device=device)
        smooth_s = time.perf_counter() - t0
        print(f"smoother: {args.smooth_passes} passes, window "
              f"±{args.smooth_window} ({smooth_s:.1f}s)", file=sys.stderr)

    poses_cam = odometry.velo_to_cam_trajectory(poses_velo, T_cam_velo)
    out_path = os.path.join(args.out, f"{seq_name}.txt")
    kitti.write_poses(out_path, poses_cam)
    print(f"wrote {out_path} ({len(poses_velo)} poses, {fps:.1f} fps "
          f"incl. host I/O)", file=sys.stderr)
    print(f"degenerate frames: {int(diag['degenerate'][1:].sum())}",
          file=sys.stderr)

    result = {"frames": len(poses_velo), "fps": round(fps, 2)}
    if gt_cam is not None:
        errs = kitti_metric.evaluate_trajectory(poses_cam, gt_cam)
        ate = kitti_metric.ate_rmse(poses_cam, gt_cam)
        result.update(ate_rmse_m=round(ate, 4), n_segments=errs.n_segments)
        if errs.n_segments > 0:  # NaN would corrupt the JSON line
            result.update(
                t_err_pct=errs.t_err_pct,
                r_err_deg_per_100m=errs.r_err_deg_per_100m,
            )
            if fwd_errs is not None and fwd_errs.n_segments > 0:
                result.update(fwd_t_err_pct=fwd_errs.t_err_pct,
                              fwd_r_err_deg_per_100m=(
                                  fwd_errs.r_err_deg_per_100m))
        print(
            f"drift: {errs.t_err_pct:.4f} %/100m trans, "
            f"{errs.r_err_deg_per_100m:.4f} deg/100m rot "
            f"({errs.n_segments} segments); ATE {ate:.3f} m",
            file=sys.stderr,
        )
    if args.plot:
        from velo_tpu_torch.evaluation import plots

        written = plots.plot_trajectory(args.out, seq_name, poses_cam,
                                        gt_cam)
        print("plots: " + ", ".join(written), file=sys.stderr)
    if args.json:
        print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
