"""Build the port's CUDA sources into shared libraries with a plain C
interface and load them with ``ctypes``; and the checks every wrapper makes
before it hands a pointer to a kernel and after the launch.

``nvcc`` compiles the sources under ``elfi_tpu_torch/csrc/`` for Hopper
(``sm_90a``) into ``build/elfi_tpu_torch/`` beside the package, at first
use.  The library's file name carries a hash of the sources, the headers
and the flags, so an edited source or header is rebuilt and an unchanged
one is loaded as it is.
No source includes PyTorch's headers, which keeps a build to seconds.
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

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "library_path", "load",
           "build_log", "check_tensor", "raise_on"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "elfi_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: name -> {"seconds": build time (0.0 if loaded from an earlier build),
#: "log": the compiler's output, kept beside the library as ``.log``}, for
#: the libraries this process loaded
build_log = {}
_loaded = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        found = str(candidate) if candidate.exists() else None
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source and need the CUDA toolkit")
    return found


def library_path(name, sources):
    """Path of the library built from ``sources`` (file names in
    ``csrc/``): keyed by a hash of their contents, of every header in
    ``csrc/`` (a source may include any of them) and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in CSRC.glob("*.cuh"))
    for s in (*sources, *headers):
        h.update(s.encode())
        h.update((CSRC / s).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name, sources):
    """Build (if needed) and load library ``name``; cached per process."""
    if name in _loaded:
        return _loaded[name]
    path = library_path(name, sources)
    log_path = path.with_suffix(".log")
    if path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        build_log[name] = {"seconds": 0.0,
                           "log": "loaded an earlier build\n" + log}
    else:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: concurrent processes
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               *(str(CSRC / s) for s in sources)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {name} ({' '.join(cmd)}):\n"
                    f"{proc.stdout}{proc.stderr}")
            # the compiler's report (ptxas -v) stays beside the library
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "log": proc.stdout + proc.stderr}
    _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]


def check_tensor(name, x, shape, device):
    """Raise ``ValueError`` unless ``x`` is a contiguous float32 tensor of
    ``shape`` on ``device``: what a kernel reads through a bare pointer."""
    if not isinstance(x, torch.Tensor):
        raise ValueError(f"{name} must be a torch.Tensor, got {type(x)}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on(rc, lib, entry):
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.elfi_cuda_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {rc} ({msg})")
