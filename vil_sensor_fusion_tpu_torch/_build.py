"""Build-at-first-use for the port's native code.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The library lands in
``build/kernels/<name>-<hash>/`` at the repository root, where ``<hash>``
covers the source and the compiler flags: an edited source builds anew,
an unchanged one is reused. The repository's host-side C++ (the rosbag
reader, ``csrc/bagreader.cpp`` at the repository root) is built the same
way with ``g++`` into ``build/native/`` (:func:`load_host`). Nothing here
runs at import time.
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
HOST_BUILD_ROOT = PACKAGE_DIR.parent / "build" / "native"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

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


def _load(name: str, src: Path, root: Path, compiler, flags: tuple
          ) -> ctypes.CDLL:
    """Build ``src`` with ``compiler()`` (the compiler's path) into
    ``root/<name>-<hash>/lib<name>.so`` unless that library exists, then
    load it."""
    if name in _LOADED:
        return _LOADED[name][0]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    out_dir = root / f"{name}-{digest}"
    lib_path = out_dir / f"lib{name}.so"
    log_path = out_dir / "build.log"
    t0 = time.perf_counter()
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [compiler(), *flags, "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{cmd[0]} failed for {src}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib_path)      # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(lib_path))
    log = log_path.read_text() if log_path.exists() else ""
    _LOADED[name] = (lib, log, time.perf_counter() - t0)
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as ``lib<name>.so``."""
    return _load(name, PACKAGE_DIR / "csrc" / f"{name}.cu", BUILD_ROOT,
                 _nvcc, NVCC_FLAGS)


def load_host(src: Path) -> ctypes.CDLL:
    """Build (if needed) and load the host C++ source ``src`` with g++ into
    ``build/native/``; the library is named after the source's stem."""
    def gxx() -> str:
        found = shutil.which("g++")
        if found is None:
            raise RuntimeError(f"g++ not found: {src} is built at first use")
        return found
    return _load(src.stem, src, HOST_BUILD_ROOT, gxx, GXX_FLAGS)


def build_info(name: str) -> tuple[str, float]:
    """(nvcc output incl. ``-Xptxas -v`` resource usage, build seconds) of
    a library loaded by :func:`load` in this process."""
    _, log, secs = _LOADED[name]
    return log, secs
