"""Traffic kind ``fleet``: a fleet operator re-running many vehicles'
logged drives on one card, the replay user multiplied.

The run's ``sequences`` (B) drives (``Context.drives``: lane i's from
``--seed`` + i), each of ``sequence_frames`` sweeps, are pre-binned on
the host in set-up with the program's ``lidar.rangeimage.bin_scan_host``,
as ``replay`` bins its one drive, and held on the card as (B, F, ...)
stacks.  The program's batch entry ``pipeline.batch.batched_run_scan``
runs them in lockstep, one batched step advancing every lane by a frame,
in chunks of ``chunk_frames`` steps; the batched carry passes from chunk
to chunk, and when the drives end every lane starts a new sequence from
``batch.broadcast_carry(init_carry, B)``.  Closed loop, at most one chunk
ahead of the card, through ``replay.window``.  The lanes share one
calibration, as ``batched_run_scan`` requires.

A frame is one sequence-frame, so a batched step is B frames: the window's
``frames``, the profiled frames and so the rates and roofline shares count
sequence-frames.  The parameters ``chunk_frames``, ``warm_frames``,
``trace_ramp_frames`` and ``trace_frames`` count batched steps, with the
meanings they have in ``replay``.  Each sequence the window returns is a
(lane, poses) pair, judged against its own lane's drive.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmarks.traffic import replay


class Fleet:
    def __init__(self, ctx):
        from velo_tpu_torch.geom import camera
        from velo_tpu_torch.lidar import rangeimage
        from velo_tpu_torch.pipeline import batch, odometry

        self.ctx, self.odo, self.batch = ctx, odometry, batch
        cfg, dev, drives = ctx.cfg, ctx.device, ctx.drives
        self.lanes, self.n = len(drives), len(drives[0].scans)
        if any(len(d.scans) != self.n for d in drives):
            raise ValueError("fleet: the drives differ in length")
        self.grids = self.masks = None
        for lane, drive in enumerate(drives):
            binned = [rangeimage.bin_scan_host(s, cfg.lidar)
                      for s in drive.scans]
            grids = torch.from_numpy(np.stack([g for g, _ in binned]))
            masks = torch.from_numpy(np.stack([m for _, m in binned]))
            if self.grids is None:
                self.grids = torch.empty((self.lanes,) + grids.shape,
                                         dtype=grids.dtype, device=dev)
                self.masks = torch.empty((self.lanes,) + masks.shape,
                                         dtype=masks.dtype, device=dev)
            self.grids[lane].copy_(grids)
            self.masks[lane].copy_(masks)
        self.images = self.cam = None
        if cfg.use_vision:
            first = drives[0]
            if any(not (np.array_equal(d.P, first.P)
                        and np.array_equal(d.T_cam_velo, first.T_cam_velo))
                   for d in drives):
                raise ValueError("fleet: the lanes' calibrations differ; "
                                 "batched_run_scan takes one")
            self.images = torch.from_numpy(
                np.stack([d.images for d in drives])).to(dev)
            self.cam = camera.from_numpy(first.P, first.T_cam_velo,
                                         cfg.vision.width, cfg.vision.height,
                                         device=dev)
        self.run = batch.batched_run_scan(cfg, self.cam)
        self.seq, self.pos, self.carry = -1, self.n, None
        self.out = []  # (sequence, pose tensor (B, steps, 4, 4) on the card)

    def advance(self, steps: int) -> int:
        """Enqueue up to ``steps`` batched steps as one ``batched_run_scan``
        call (fewer where the drives end); returns the sequence-frames."""
        if self.pos == self.n:
            self.seq, self.pos = self.seq + 1, 0
            self.carry = self.batch.broadcast_carry(
                self.odo.init_carry(self.ctx.cfg, self.ctx.device),
                self.lanes)
        a, b = self.pos, min(self.pos + steps, self.n)
        self.carry, res = self.run(
            self.carry, self.grids[:, a:b], self.masks[:, a:b],
            None if self.images is None else self.images[:, a:b])
        self.out.append((self.seq, res.T_w))
        self.pos = b
        return (b - a) * self.lanes

    def restart(self):
        """The next step starts a new sequence in every lane; forget the
        poses so far."""
        self.pos, self.out = self.n, []

    def poses(self) -> list:
        """(lane, (F, 4, 4) poses) of every lane of every sequence."""
        seqs: dict = {}
        for s, t in self.out:
            seqs.setdefault(s, []).append(t.cpu().numpy())
        out = []
        for _, chunks in sorted(seqs.items()):
            stacked = np.concatenate(chunks, axis=1)
            out += [(lane, stacked[lane]) for lane in range(self.lanes)]
        return out


def prepare(ctx) -> Fleet:
    f = Fleet(ctx)
    f.advance(ctx.params["warm_frames"])
    ctx.sync()
    f.restart()
    return f


# The replay user's closed loop: ``advance`` counts sequence-frames.
window = replay.window


def profile(ctx, f: Fleet, steps: int):
    """(sequence-frames between the markers, host seconds of the whole)
    inside the caller's profiler: ``steps`` batched steps, after a ramp,
    between two ``harness.MARKER`` kernels, as ``replay.profile``."""
    chunk = ctx.params["chunk_frames"]
    ctx.sync()
    t0 = time.perf_counter()
    f.advance(ctx.params["trace_ramp_frames"])
    pending = [ctx.event()]
    ctx.mark()
    done = 0
    while done < steps:
        done += f.advance(min(chunk, steps - done)) // f.lanes
        pending.append(ctx.event())
        pending.pop(0).synchronize()
    ctx.mark()
    ctx.sync()
    return done * f.lanes, time.perf_counter() - t0
