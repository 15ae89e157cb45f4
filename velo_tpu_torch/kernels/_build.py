"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

plus the source's own flags (``SOURCE_FLAGS``) into
``velo_tpu_torch/_build/lib<name>-<sha>.so``, where ``<sha>`` is a hash of
the source, the sources it includes (``#include "..."``) and those flags:
an edited source is rebuilt, an unchanged one is loaded as built.
Nothing outside the package's own ``csrc/`` is compiled, and the library
includes no PyTorch header, so a build takes seconds.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# lm_lidar and lm_joint mirror the plain path's float32 roundings
# operation for operation: no multiply and add may fuse.
SOURCE_FLAGS = {"lm_lidar": ["-fmad=false"], "lm_joint": ["-fmad=false"]}
_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.M)

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
    flags = " ".join(SOURCE_FLAGS.get(name, [])).encode()
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
    cmd = [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(name, []), "-o", str(tmp),
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


def load_variant(src: Path, out_name: str, flags=()) -> ctypes.CDLL:
    """Compile any source with the package's flags plus ``flags`` into
    ``_build/lib<out_name>.so`` (always rebuilt) and load it: for tools
    that time an earlier design's source or a profiling build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{out_name}.so"
    done = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(out), str(src)],
        capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (rc {done.returncode}):\n"
                           f"{done.stdout}{done.stderr}")
    build_logs[out_name] = done.stdout + done.stderr
    return ctypes.CDLL(str(out))


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _libs[name] = lib
    return lib
