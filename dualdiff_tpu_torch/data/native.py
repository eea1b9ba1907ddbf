"""ctypes binding to the port's native data path (``csrc/dualdiff_native.cc``).

The source is a copy of the JAX package's ``native/dualdiff_native.cc``: a
libjpeg batch decode with bilinear resize, bottom crop and [-1, 1]
normalisation across the six views, and the bit-pack codec of the BEV mask
cache.  At first use it is compiled with ``g++`` into
``build/dualdiff_tpu_torch/`` at the repository root, named by a hash of the
source and the flags (as ``ops/cuda_lib.py`` names the CUDA libraries), and
loaded.  Nothing is built at import time, and nothing under the JAX
package's ``native/`` is built or loaded.

The interface is the JAX binding's: ``available``, ``unpack_masks``,
``pack_masks`` and ``load_images_batch``, each returning ``None`` where the
library is unavailable (no compiler, no libjpeg) and, for the decode, for a
non-JPEG or a failed decode.  Callers then take their own numpy / PIL path.
``status()`` says which path the binding took and why.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np

log = logging.getLogger(__name__)

__all__ = ["SOURCE", "CXX_FLAGS", "LIBS", "available", "library_path",
           "status", "unpack_masks", "pack_masks", "load_images_batch"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "dualdiff_native.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "dualdiff_tpu_torch")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
LIBS = ["-ljpeg", "-lpthread"]

_LIB: Optional[ctypes.CDLL] = None
_STATUS: Optional[Dict] = None
# the first use may come from the reader's worker threads (prefetch_map):
# one of them builds and loads, the others wait for its status
_LOCK = threading.Lock()


def library_path() -> str:
    """Where the built library goes: a hash of the source and flags."""
    key = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    with open(SOURCE, "rb") as f:
        key.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"dualdiff_native-{key.hexdigest()[:16]}.so")


def _compiler() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")


def _build(out: str) -> Dict:
    """Compile the source into ``out``.  -> the status of the attempt."""
    cxx = _compiler()
    if cxx is None:
        return {"path": "unavailable", "reason": "no C++ compiler (g++)",
                "compiler": None, "libjpeg": False, "build_s": 0.0}
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a file of its own per build: another process may build the same
    # library at the same time
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        p = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE, *LIBS],
                           capture_output=True, text=True, timeout=300)
        secs = time.perf_counter() - t0
        if p.returncode != 0:
            msg = (p.stderr or p.stdout).strip()
            return {"path": "unavailable", "reason": msg[-2000:],
                    "compiler": cxx, "build_s": secs,
                    "libjpeg": "jpeglib.h" not in msg and "-ljpeg" not in msg}
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return {"path": "built", "reason": None, "compiler": cxx,
            "libjpeg": True, "build_s": secs}


def _load() -> Optional[ctypes.CDLL]:
    if _STATUS is not None:
        return _LIB
    with _LOCK:
        if _STATUS is None:
            _load_locked()
    return _LIB


def _load_locked() -> None:
    global _LIB, _STATUS
    out = library_path()
    if os.path.exists(out):
        st = {"path": "loaded", "reason": None, "compiler": _compiler(),
              "libjpeg": True, "build_s": 0.0}
    else:
        try:
            st = _build(out)
        except (OSError, subprocess.SubprocessError) as e:
            st = {"path": "unavailable", "reason": f"{_compiler()}: {e!r}",
                  "compiler": _compiler(), "libjpeg": False, "build_s": 0.0}
    if st["path"] != "unavailable":
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:
            st = {**st, "path": "unavailable", "reason": f"load: {e}"}
        else:
            lib.unpack_masks.argtypes = [
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
            lib.pack_masks.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint32)]
            lib.load_images_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float)]
            lib.load_images_batch.restype = ctypes.c_int
            _LIB = lib
    if _LIB is None:
        log.info("native lib unavailable (%s); using python data path",
                 st["reason"])
    st["library"] = out if _LIB is not None else None
    _STATUS = st


def status() -> Dict:
    """How the binding stands (building or loading it first if not tried):
    ``path`` "built" (compiled in this process), "loaded" (found built) or
    "unavailable"; ``reason`` (the compiler's or loader's message where
    unavailable), ``compiler``, ``libjpeg`` (whether the build got past
    libjpeg's header and library), ``build_s``, ``library``."""
    _load()
    return dict(_STATUS)


def available() -> bool:
    return _load() is not None


def unpack_masks(packed: np.ndarray, channels: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, np.uint32)
    h, w = packed.shape
    out = np.empty((channels, h, w), np.uint8)
    lib.unpack_masks(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        channels, h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def pack_masks(masks: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    masks = np.ascontiguousarray(masks, np.uint8)
    c, h, w = masks.shape
    out = np.empty((h, w), np.uint32)
    lib.pack_masks(
        masks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        c, h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


def load_images_batch(paths: List[str], ratio: float, out_h: int, out_w: int,
                      num_threads: int = 6) -> Optional[np.ndarray]:
    """Decode + resize + bottom-crop + normalize N JPEGs in parallel.
    -> (N, out_h, out_w, 3) float32 in [-1, 1], or None (the caller's own
    path: no library, a non-JPEG, or a failed decode)."""
    lib = _load()
    if lib is None:
        return None
    if not all(p.lower().endswith((".jpg", ".jpeg")) for p in paths):
        return None
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.load_images_batch(
        arr, n, ctypes.c_float(ratio), out_h, out_w, num_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if failures:
        log.warning("native decode failed for %d/%d images", failures, n)
        return None
    return out

