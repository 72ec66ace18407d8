"""Builds the port's CUDA kernels and loads them with ctypes.

Each kernel is one source `dyobav_tpu_torch/csrc/<name>.cu` with a plain C
entry point.  It is compiled with `nvcc` for Hopper (`sm_90a`) into a shared
library under `dyobav_tpu_torch/_build/` (git-ignored), named after a hash
of the source, the first time it is needed.  Nothing is compiled when a
module is imported; this module itself imports nothing beyond the standard
library, and looks for `nvcc` only when asked to build.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildResult(NamedTuple):
    path: Path          # the shared library
    seconds: float      # wall time of the nvcc call (0.0 when reused)
    log: str            # nvcc's output, including -Xptxas -v resource usage


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (CUDA_HOME unset and no nvcc on PATH): the port's "
        "CUDA kernels are built from source at first use and need the CUDA "
        "toolkit")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> BuildResult:
    """Compile the named kernel, reusing a library already built from the
    same source.  Raises with nvcc's output if the compile fails."""
    out = library_path(name)
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return BuildResult(out, seconds, proc.stdout)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed (memoized)."""
    return ctypes.CDLL(str(build(name).path))
