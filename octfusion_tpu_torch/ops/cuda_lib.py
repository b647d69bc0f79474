"""A CUDA source of ``csrc/`` as a shared library with a plain C interface:
built with ``nvcc`` for ``sm_90a``, loaded with ``ctypes``, and called on
PyTorch's current stream with its tensors checked first.

A library is built at its first use on a GPU, into the package's
``build/`` directory, keyed by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is not.  Nothing here runs
at import."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from ..utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built with "
                       "the CUDA toolkit at first use on a GPU")


def build(source: str) -> str:
    """Compile ``source`` (if this exact source has not been built yet)
    and return the library path."""
    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    lib = os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:12]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, lib)
    return lib


def load(source: str, signatures) -> ctypes.CDLL:
    """Build ``source`` and load it; ``signatures`` maps each C entry
    point to its argument types (each returns a CUDA error code)."""
    with trace.span("octf.setup.kernels"):
        lib = ctypes.CDLL(build(source))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``ndim``
    dimensions on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def call(lib: ctypes.CDLL, name: str, device, *args) -> None:
    """Launch the entry point ``name`` with ``args`` and the current
    stream of ``device``; raise if the launch returned a CUDA error."""
    fn = getattr(lib, name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
