"""The odometry step replayed from captured CUDA graphs: the counterpart
of the reference's ``jax.jit`` over ``step`` and ``lax.scan`` over the
frames, one compiled device program per frame.

Eagerly, one step is tens of thousands of small kernels, each dispatched
by the host (``PERF.md`` §5).  A :class:`CapturedStep` records them once
into a CUDA graph and then launches the whole step with one ``replay()``.

The step is free of host syncs and of host-to-device copies; its only host
decisions are the map cadences on ``carry.frame_host`` (refine every
``map_every`` frames, maintain every ``maintain_every``:
``odometry.cadence_key``).  So one graph is captured per cadence key, at
most four per configuration, each the first
time a frame needs it: an eager warm-up on a side stream (library handles,
lazy kernel loading, the allocator's blocks), then the capture.  All
graphs of one configuration share the static buffers of the carry and of
the frame's inputs:

* the inputs are copied into the static buffers before a replay (a carry
  that *is* the static carry is not copied: frame after frame the carry
  stays where the graph left it);
* inside the graph the new carry is written back into the static carry,
  so one frame is one ``replay()``;
* the per-frame result, which lives in the graph's own memory until its
  next replay, is copied out after each replay.

The carry a replay returns is the static carry itself (the reference's
``jit_step`` donates its carry the same way): the next call of the same
configuration overwrites it.  A capture that fails raises, naming the
line of the operation that refused it; nothing falls back to the eager
step.  The kernels' libraries and the stage marks' are built before the
first capture, and every mark is launched once in the eager warm-up.

Inside the capture the carry's write-back is the step's last stage
(``carry``), and ``velo_stage_end`` closes the graph
(``evaluation/profiling.py``).  While a profiler is active a call shows
the host spans ``velo.graphs.copy_in``, ``velo.graphs.launch`` (the
replay) and ``velo.graphs.result`` (the result's copy); while none is,
the host seconds of each replay are counted in ``profiling.counters()``
(``graphs.launch``), which ``release()`` does not clear.
"""
from __future__ import annotations

import os
import time
import traceback
from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from velo_tpu_torch.evaluation import profiling
from velo_tpu_torch.kernels import _build

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Capture(NamedTuple):
    """One captured graph: its configuration's name, cadence key, and the
    seconds of the eager warm-up and of the capture itself."""
    name: str
    key: tuple
    warm_s: float
    capture_s: float


def _signature(tree) -> tuple:
    """What a graph is specialised to: the tree's structure, each tensor
    leaf's shape, dtype and device, and every other leaf's value."""
    leaves, spec = pytree.tree_flatten(tree)
    return (str(spec),) + tuple(
        (tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor)
        else x for x in leaves)


def _tensors(tree) -> list:
    return [x for x in pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def clone(tree):
    """``tree`` with each tensor leaf copied (a carry that a graph's next
    replay will overwrite, kept)."""
    return pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def _copy_in(static, tree) -> None:
    """Copy every tensor leaf of ``tree`` into ``static``'s, skipping the
    leaves that are the static buffers already."""
    for dst, src in zip(_tensors(static), _tensors(tree)):
        if src is not dst:
            dst.copy_(src)


def _write_back(static, new) -> None:
    """Inside the capture: the new carry into the static carry.  A new
    leaf that shares memory with a static one (the unchanged map on a
    path without one) is read whole before any static leaf is written."""
    dsts, srcs = _tensors(static), _tensors(new)
    if len(dsts) != len(srcs):
        raise RuntimeError("the step changed the carry's structure")
    owned = {d.untyped_storage().data_ptr() for d in dsts}
    staged = []
    for d, s in zip(dsts, srcs):
        if s.shape != d.shape or s.dtype != d.dtype:
            raise RuntimeError(
                f"carry leaf {tuple(d.shape)} {d.dtype} became "
                f"{tuple(s.shape)} {s.dtype}: the carry must keep its shape")
        if s is not d and s.untyped_storage().data_ptr() in owned:
            s = s.clone()
        staged.append(s)
    for d, s in zip(dsts, staged):
        if s is not d:
            d.copy_(s)


def _where(err: BaseException) -> str:
    """The innermost line of this package in ``err``'s traceback."""
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if f.filename.startswith(_PKG)]
    if not frames:
        return "outside velo_tpu_torch"
    f = frames[-1]
    return (f"{os.path.relpath(f.filename, os.path.dirname(_PKG))}:"
            f"{f.lineno} `{f.line}`")


class CapturedStep:
    """``fn(carry, *inputs) -> (new_carry, result)`` on the card, replayed
    from one CUDA graph per cadence key.

    ``carry`` is a NamedTuple whose ``frame_host`` is the host frame
    counter and whose other leaves are tensors (or None); ``fn`` must not
    change the carry's shapes.  ``inputs`` is any tree of tensors and
    constants (the frame, the camera).
    """

    def __init__(self, name: str, fn: Callable, cadence: Callable,
                 libraries=_build.step_libraries(use_vision=False)):
        self.name = name
        self._fn = fn
        self._cadence = cadence
        self._libraries = list(libraries)  # built before the first capture
        self._carry = None  # the static carry, frame_host None
        self._inputs = None  # the static inputs
        self._graphs: dict = {}  # cadence key -> (graph, static result)
        self.captures: list[Capture] = []

    def __call__(self, carry, *inputs):
        frame_host = carry.frame_host
        with profiling.span("velo.graphs.copy_in"):
            if self._carry is None:
                self._carry = clone(carry._replace(frame_host=None))
                self._inputs = clone(inputs)
            else:
                _copy_in(self._carry, carry._replace(frame_host=None))
                _copy_in(self._inputs, inputs)
        key = self._cadence(frame_host)
        if key not in self._graphs:
            self._graphs[key] = self._capture(key, frame_host)
        graph, result = self._graphs[key]
        if profiling.profiler_active():
            with profiling.span("velo.graphs.launch"):
                graph.replay()
        else:
            t0 = time.perf_counter()
            graph.replay()
            profiling.add("graphs.launch", time.perf_counter() - t0)
        with profiling.span("velo.graphs.result"):
            out = clone(result)
        return self._carry._replace(frame_host=frame_host + 1), out

    def _capture(self, key, frame_host):
        _build.build_all(self._libraries)
        dev = _tensors(self._carry)[0].device
        carry = self._carry._replace(frame_host=frame_host)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            profiling.warm_marks()
            self._fn(carry, *self._inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                new, result = self._fn(carry, *self._inputs)
                with profiling.stage("carry"):
                    _write_back(self._carry, new._replace(frame_host=None))
                profiling.stage_end()
        except Exception as err:
            raise RuntimeError(
                f"CUDA-graph capture of {self.name} (cadence key {key}) "
                f"failed at {_where(err)}: {type(err).__name__}: {err}"
            ) from err
        self.captures.append(Capture(self.name, key, t1 - t0,
                                     time.perf_counter() - t1))
        return graph, result


_runners: dict = {}


def runner(name: str, cfg, fn: Callable, carry, inputs,
           cadence: Callable) -> CapturedStep:
    """The :class:`CapturedStep` of ``fn`` for this configuration and
    these shapes (one per (name, cfg, carry and input signature));
    ``cadence(frame_host)`` is the cadence key of a frame."""
    key = (name, cfg, _signature(carry._replace(frame_host=None)),
           _signature(inputs))
    found = _runners.get(key)
    if found is None:
        found = CapturedStep(name, fn, cadence,
                             _build.step_libraries(cfg.use_vision))
        _runners[key] = found
    return found


def captures() -> list[Capture]:
    """Every graph captured in this process so far, in order."""
    return [c for r in _runners.values() for c in r.captures]


def release() -> None:
    """Drop every captured graph and its static buffers (their memory
    returns to the caching allocator)."""
    _runners.clear()
