"""The port's CUDA libraries: which exist, and how each is built, loaded,
launched, counted and batched.

Each ``csrc/<name>.cu`` of ``LIBRARIES`` exposes plain C entry points and
is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

plus the library's own flags into
``velo_tpu_torch/_build/lib<name>-<sha>.so``, where ``<sha>`` is a hash of
the source, the sources it includes (``#include "..."``) and those flags:
an edited source is rebuilt, an unchanged one is loaded as built.
Nothing outside the package's own ``csrc/`` is compiled, and the library
includes no PyTorch header, so a build takes seconds.

A kernel's wrapper declares its C entry point as an :class:`Entry` and
launches it through :meth:`Entry.launch`, which counts each launch as
``kernel.<name>`` in ``profiling.counters()`` (a batched call is one), and
gives its custom operator the batching rule :func:`register_vmap`.  A new
kernel is one ``csrc/<name>.cu``, one entry of ``LIBRARIES`` and one
wrapper in ``kernels/``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from velo_tpu_torch.evaluation import profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.M)


class Library(NamedTuple):
    """One ``csrc/<name>.cu``."""
    flags: tuple[str, ...] = ()  # nvcc flags of its own
    kernel: bool = True  # a compute kernel (not the stage marks)
    vision: bool = False  # launched only by a step with images


# lm_lidar, lm_joint and corr_fit mirror the plain path's float32
# roundings operation for operation: no multiply and add may fuse.
# lm_joint, the slowest to build (~19 s), is a library of its own so that a
# LiDAR-only step never waits for it.
LIBRARIES = {"dist_topk": Library(), "klt_l0": Library(),
             "lm_lidar": Library(("-fmad=false",)),
             "lm_joint": Library(("-fmad=false",), vision=True),
             "corr_fit": Library(("-fmad=false",)),
             "stage_mark": Library(kernel=False)}
# The port's CUDA kernels: each name is in its kernel's and no other's.
KERNELS = tuple(name for name, lib in LIBRARIES.items() if lib.kernel)


def step_libraries(use_vision: bool) -> tuple[str, ...]:
    """The libraries an odometry step may launch, which
    ``pipeline/graphs`` builds (in parallel) before its first capture."""
    return tuple(name for name, lib in LIBRARIES.items()
                 if use_vision or not lib.vision)


_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}
build_logs: dict[str, str] = {}  # nvcc's output (-Xptxas -v: registers)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def _source_bytes(src: Path) -> bytes:
    """The source and, after it, each source it includes by a quoted
    ``#include``, recursively."""
    text = src.read_bytes()
    return text + b"".join(_source_bytes(src.parent / inc.decode())
                           for inc in _INCLUDE.findall(text))


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    flags = " ".join(LIBRARIES[name].flags).encode()
    sha = hashlib.sha256(_source_bytes(src) + flags).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{sha}.so"


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu`` -> (output, temp, process, t0), or
    None when this source is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *LIBRARIES[name].flags, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc, time.perf_counter()


def _finish(name: str, job) -> Path:
    out, tmp, proc, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a torn file
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = log
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this source is already built."""
    return build_all([name])[name]


def build_all(names) -> dict[str, Path]:
    """Compile several sources at once: one nvcc process each, all started
    before any is awaited."""
    jobs = {name: _start(name) for name in names}
    built, errors = {}, []
    for name, job in jobs.items():  # wait for every process, then report
        try:
            built[name] = (library_path(name) if job is None
                           else _finish(name, job))
        except RuntimeError as err:
            errors.append(str(err))
    if errors:
        raise RuntimeError("\n".join(errors))
    return built


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _libs[name] = lib
    return lib


class Entry:
    """The C entry point ``symbol`` of ``csrc/<library>.cu``: ``argtypes``
    then the CUDA stream, returning a ``cudaError_t`` (``int``); loaded,
    and its library built, at its first call."""

    def __init__(self, library: str, symbol: str, argtypes,
                 plain: str | None = None):
        self.library, self.symbol, self.argtypes = library, symbol, argtypes
        self.plain = plain or f"{library}_reference"
        self._fn = None

    def __call__(self, *args) -> int:
        if self._fn is None:
            fn = getattr(load(self.library), self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn(*args)

    def require_cuda(self, x: torch.Tensor) -> None:
        """Refuse a tensor off the card: nothing falls back to the plain
        version."""
        if x.device.type != "cuda":
            raise ValueError(f"{self.library} runs on CUDA tensors only, not "
                             f"{x.device}: the plain version is {self.plain}")

    def launch(self, x: torch.Tensor, *args) -> None:
        """One launch with ``args`` on the current stream of ``x``'s card,
        counted as ``kernel.<library>``; raises on a CUDA error."""
        self.require_cuda(x)
        with torch.cuda.device(x.device):
            err = self(*args, torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"{self.library} kernel launch failed: CUDA error {err}")
        profiling.add(f"kernel.{self.library}")


# The stage marks' entry point (``evaluation/profiling.launch_mark``).
STAGE_MARK = Entry("stage_mark", "velo_stage_mark", [ctypes.c_int])


def batch_front(x: torch.Tensor, dim, size: int) -> torch.Tensor:
    """``x`` with its vmapped axis ``dim`` (None: unbatched, expanded at
    stride 0) merged into its leading batch axis: (size * B, ...)."""
    x = x.expand(size, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.reshape(size * x.shape[1], *x.shape[2:])


def register_vmap(op) -> None:
    """Give the custom operator ``op``, whose tensor arguments and outputs
    all carry a leading batch axis, its ``torch.func.vmap`` rule: each
    tensor argument's vmapped axis joins that axis (None passes through),
    ``op`` runs once for all lanes (one launch on the card) and each output
    is viewed back to (lanes, -1, ...)."""

    def rule(info, in_dims, *inputs):
        v = info.batch_size
        outs = op(*(batch_front(x, d, v) if isinstance(x, torch.Tensor)
                    else x for x, d in zip(inputs, in_dims)))
        return (tuple(o.view(v, -1, *o.shape[1:]) for o in outs),
                (0,) * len(outs))

    op.register_vmap(rule)
