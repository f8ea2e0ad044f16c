"""Build-at-first-use for the port's CUDA kernels.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The library lands in
``build/kernels/<name>-<hash>/`` at the repository root, where ``<hash>``
covers the source and the compiler flags: an edited source builds anew,
an unchanged one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> (CDLL, build log, seconds spent building in this process)
_LOADED: dict[str, tuple[ctypes.CDLL, str, float]] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use and need the CUDA toolkit")
    return found


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as ``lib<name>.so``."""
    if name in _LOADED:
        return _LOADED[name][0]
    src = PACKAGE_DIR / "csrc" / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"{name}-{digest}"
    lib_path = out_dir / f"lib{name}.so"
    log_path = out_dir / "build.log"
    t0 = time.perf_counter()
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib_path)      # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(lib_path))
    log = log_path.read_text() if log_path.exists() else ""
    _LOADED[name] = (lib, log, time.perf_counter() - t0)
    return lib


def build_info(name: str) -> tuple[str, float]:
    """(nvcc output incl. ``-Xptxas -v`` resource usage, build seconds) of
    a library loaded by :func:`load` in this process."""
    _, log, secs = _LOADED[name]
    return log, secs
