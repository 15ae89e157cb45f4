"""CUDA-event timing of a call on the card."""
from __future__ import annotations

import numpy as np
import torch


def median_ms(fn, bursts: int = 21, calls: int = 10) -> float:
    """Median over ``bursts`` timings, after warm-up, of the card time per
    call from CUDA events around ``calls`` back-to-back calls: queued back
    to back, the card does not wait on the host between small launches."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(bursts):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def graph_ms(fn, calls: int = 20, replays: int = 21) -> float:
    """Card time per call with the host out of the way: ``calls``
    invocations of ``fn`` are captured into one CUDA graph, and the median
    over ``replays`` replays of the event time around a replay is divided
    by ``calls``.  ``fn`` may allocate with ``torch.empty`` and must launch
    on the current stream."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))
