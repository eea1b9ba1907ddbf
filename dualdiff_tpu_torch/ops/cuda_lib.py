"""Build and load the port's CUDA kernels (``dualdiff_tpu_torch/csrc``).

Each ``.cu`` source is compiled by ``nvcc`` into a shared library with a
plain ``extern "C"`` interface and loaded with ``ctypes``.  Builds go to
``build/dualdiff_tpu_torch/`` at the repository root, named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source rebuilds and an unchanged one is reused.  Nothing here runs at
import time: the CPU tests import every module on machines that have no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, List

__all__ = ["BUILD_DIR", "SOURCES", "build", "library", "library_path"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "dualdiff_tpu_torch")

# library name -> source file under csrc/
SOURCES = {"attention": "attention.cu",
           "attention_train": "attention_train.cu",
           "attention_sm90": "attention_sm90.cu",
           "attention_sm90_bwd": "attention_sm90_bwd.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# argtypes of every C entry point: pointers and the stream are c_void_p
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "attention": {
        # q, k, v, o, batch, lq, lk, heads, head_dim, scale, stream
        "dd_packed_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                    _P],
        # q, k, v, o, batch (B*N), l, heads, head_dim, n_cam, scale, stream
        "dd_packed_attention_nbr_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _F, _P],
        # q, k, v, o, lse, batch, lq, lk, heads, head_dim, scale, stream
        "dd_packed_attention_lse_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _F, _P],
        # q, k, v, o, batch, lq, lk, heads, head_dim, warps, scale, stream
        "dd_packed_attention_capped_fwd": [_P, _P, _P, _P, _I, _I, _I, _I,
                                           _I, _I, _F, _P],
        # q, k, v, o, lse, batch, lq, lk, heads, head_dim, warps, scale,
        # stream
        "dd_packed_attention_capped_lse_fwd": [_P, _P, _P, _P, _P, _I, _I,
                                               _I, _I, _I, _I, _F, _P],
        # split layout (B, L, H, D): q, k, v, o, batch, lq, lk, heads,
        # head_dim, scale, stream
        "dd_flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                   _P],
        # q, k, v, o, lse, batch, lq, lk, heads, head_dim, scale, stream
        "dd_flash_attention_lse_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _F, _P],
    },
    "attention_train": {
        # q, k, v, do, lse, delta, dq, batch, lq, lk, heads, head_dim,
        # scale, stream
        "dd_packed_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _I, _F, _P],
        # q, k, v, do, lse, delta, dk, dv, batch, lq, lk, heads, head_dim,
        # scale, stream
        "dd_packed_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                        _I, _I, _I, _I, _F, _P],
        # split layout, the packed entries' arguments
        "dd_flash_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _I, _F, _P],
        "dd_flash_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                       _I, _I, _I, _I, _F, _P],
    },
    "attention_sm90": {
        # q, k, v, o, batch, lq, lk, heads, head_dim, scale, stream
        "dd_sm90_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                  _P],
        # the arguments of dd_packed_attention_lse_fwd
        "dd_sm90_attention_lse_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _F, _P],
        # the arguments of dd_packed_attention_nbr_fwd
        "dd_sm90_attention_nbr_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                      _P],
    },
    "attention_sm90_bwd": {
        # the arguments of dd_packed_attention_bwd_dq / _dkv
        "dd_sm90_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _F, _P],
        "dd_sm90_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      _I, _I, _I, _I, _F, _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the GPU machine (CUDA_HOME or PATH)")
    return path


def library_path(name: str) -> str:
    """Path of the built library ``name`` (its compiler log: ``.log``)."""
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for fname in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            key.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{key.hexdigest()[:16]}.so")


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns the seconds each
    build took (0.0 for a library found already built).  The compiler's
    resource report (``-Xptxas=-v``) is kept beside each library as
    ``<lib>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo: List = []
    secs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            secs[name] = 0.0
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        todo.append((name, out, tmp, proc, time.perf_counter()))
    for name, out, tmp, proc, t0 in todo:
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        with open(out[:-3] + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
