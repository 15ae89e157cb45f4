"""Traffic kind ``replay``: the offline user replaying logged drives with
the whole system on the card.

The drive (``sequence_frames`` sweeps, pre-binned on the host in set-up
with the program's ``lidar.rangeimage.bin_scan_host``, as the program's
loader does during prefetch) lives on the card.  ``odometry.run_scan``
runs over it in chunks of ``chunk_frames``, the carry passing from chunk
to chunk; each time the drive ends a new sequence starts from
``init_carry``.  One sequence at a time, closed loop: the host enqueues
at most one chunk ahead of the card, so the card is always fed and the
window's closing synchronise waits for at most two chunks.

The card's seconds between the ends of consecutive chunks (CUDA events)
are kept as ``device_chunk_s``, for the run's standard error.

Parameters (the workload file's ``params``): ``chunk_frames``,
``warm_frames`` (frames through the same entry in set-up: every captured
graph of the configuration), ``trace_ramp_frames`` and ``trace_frames``
(a ``--trace 1`` run profiles a ramp of the first, which fills the launch
queue, then a ``harness.MARKER`` kernel, the second in chunks one ahead
as in the window, and a second marker: the trace is read between the two,
so the card's steady state, not the profiler's start, is measured).
"""
from __future__ import annotations

import time

import numpy as np
import torch


class Replay:
    def __init__(self, ctx):
        from velo_tpu_torch.geom import camera
        from velo_tpu_torch.lidar import rangeimage
        from velo_tpu_torch.pipeline import odometry

        self.ctx, self.odo = ctx, odometry
        cfg, dev, drive = ctx.cfg, ctx.device, ctx.drive
        binned = [rangeimage.bin_scan_host(s, cfg.lidar) for s in drive.scans]
        self.grids = torch.from_numpy(np.stack([g for g, _ in binned])).to(dev)
        self.masks = torch.from_numpy(np.stack([m for _, m in binned])).to(dev)
        self.images = self.cam = None
        if cfg.use_vision:
            self.images = torch.from_numpy(drive.images).to(dev)
            self.cam = camera.from_numpy(drive.P, drive.T_cam_velo,
                                         cfg.vision.width, cfg.vision.height,
                                         device=dev)
        self.n = self.grids.shape[0]
        self.seq, self.pos, self.carry = -1, self.n, None
        self.out = []  # (sequence, pose tensor (n, 4, 4) on the card)

    def advance(self, frames: int) -> int:
        """Enqueue up to ``frames`` frames as one ``run_scan`` call (fewer
        where the drive ends); returns how many."""
        if self.pos == self.n:
            self.seq, self.pos = self.seq + 1, 0
            self.carry = self.odo.init_carry(self.ctx.cfg, self.ctx.device)
        a, b = self.pos, min(self.pos + frames, self.n)
        self.carry, res = self.odo.run_scan(
            self.carry, self.grids[a:b], self.masks[a:b], self.ctx.cfg,
            images=None if self.images is None else self.images[a:b],
            cam=self.cam)
        self.out.append((self.seq, res.T_w))
        self.pos = b
        return b - a

    def restart(self):
        """The next frame starts a new sequence; forget the poses so far."""
        self.pos, self.out = self.n, []

    def poses(self) -> list:
        seqs: dict = {}
        for s, t in self.out:
            seqs.setdefault(s, []).append(t.cpu().numpy())
        return [np.concatenate(v) for _, v in sorted(seqs.items())]


def prepare(ctx) -> Replay:
    r = Replay(ctx)
    r.advance(ctx.params["warm_frames"])
    ctx.sync()
    r.restart()
    return r


def window(ctx, r: Replay, seconds: float) -> dict:
    chunk = ctx.params["chunk_frames"]
    frames, pending, ends, enqueue_s, wait_s = 0, [], [], 0.0, 0.0
    ctx.sync()
    t0 = time.perf_counter()
    while True:
        ta = time.perf_counter()
        frames += r.advance(chunk)
        pending.append(ctx.event())
        tb = time.perf_counter()
        if len(pending) > 1:  # at most one chunk ahead of the card
            ends.append(pending.pop(0))
            ends[-1].synchronize()
        enqueue_s += tb - ta
        wait_s += time.perf_counter() - tb
        if time.perf_counter() - t0 >= seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    ends += pending
    out = {"frames": frames, "window_s": window_s, "sequences": r.poses(),
           "host_enqueue_s": enqueue_s, "host_wait_s": wait_s}
    if ctx.cuda:
        out["device_chunk_s"] = [1e-3 * a.elapsed_time(b)
                                 for a, b in zip(ends, ends[1:])]
    return out


def profile(ctx, r: Replay, frames: int):
    """(frames between the markers, host seconds of the whole) inside the
    caller's profiler."""
    chunk = ctx.params["chunk_frames"]
    ctx.sync()
    t0 = time.perf_counter()
    r.advance(ctx.params["trace_ramp_frames"])
    pending = [ctx.event()]
    ctx.mark()
    done = 0
    while done < frames:
        done += r.advance(min(chunk, frames - done))
        pending.append(ctx.event())
        pending.pop(0).synchronize()
    ctx.mark()
    ctx.sync()
    return done, time.perf_counter() - t0
