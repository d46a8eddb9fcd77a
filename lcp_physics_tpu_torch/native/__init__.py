"""Host-side C++ for the object layer: the sweep-and-prune broadphase.

Counterpart of ``lcp_physics_tpu/native``.  ``csrc/broadphase.cpp`` (this
package's copy) is compiled with ``g++`` at first use into ``build/`` inside
this package, under a name keyed by a hash of the source and the flags, and
bound with ``ctypes``.  Without a C++ compiler, or if the build fails, the
NumPy all-pairs version runs instead: this is host code, not a device
kernel.  ``LAST_PATH`` says which one the last ``sap_pairs`` call ran
(``"cpp"`` or ``"numpy"``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "broadphase.cpp"
_BUILD = _PKG / "build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_tried = False
_lock = threading.Lock()
LAST_PATH = None
BUILD_ERROR = None


def _build_and_load():
    """The loaded library, built first if needed; None when no compiler is
    found or the build fails (the failure is kept in ``BUILD_ERROR``)."""
    global _lib, _tried, BUILD_ERROR
    with _lock:
        if _tried:
            return _lib
        _tried = True
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            return None
        key = hashlib.sha256(" ".join(_FLAGS).encode()
                             + _SRC.read_bytes()).hexdigest()[:16]
        out = _BUILD / f"libbroadphase_{key}.so"
        try:
            if not out.exists():
                _BUILD.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
                os.close(fd)
                try:
                    subprocess.run([cxx, *_FLAGS, str(_SRC), "-o", tmp],
                                   check=True, capture_output=True)
                    os.replace(tmp, out)   # atomic: never a half-written .so
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.CalledProcessError) as e:
            BUILD_ERROR = e
            return None
        lib.sap_pairs.restype = ctypes.c_int64
        lib.sap_pairs.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        _lib = lib
        return lib


def sap_pairs(aabbs, mask=None, cap=None):
    """Overlapping AABB pairs by sweep-and-prune.

    aabbs: (N, 4) float array [minx, miny, maxx, maxy].
    mask: optional (N,) bool of active bodies.
    Returns an (K, 2) int32 array of pairs with i < j, sorted.
    """
    global LAST_PATH
    aabbs = np.ascontiguousarray(np.asarray(aabbs, np.float32))
    n = aabbs.shape[0]
    if cap is None:
        cap = max(4 * n, 64)
    lib = _build_and_load()
    if lib is None:
        LAST_PATH = "numpy"
        return _sap_pairs_numpy(aabbs, mask)
    mask_arr = None
    mask_ptr = ctypes.POINTER(ctypes.c_uint8)()
    if mask is not None:
        mask_arr = np.ascontiguousarray(np.asarray(mask, np.uint8))
        mask_ptr = mask_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    boxes = aabbs.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    out = np.empty((cap, 2), np.int32)
    count = lib.sap_pairs(boxes, n, mask_ptr,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                          cap)
    if count > cap:  # retry with exact capacity
        out = np.empty((count, 2), np.int32)
        count = lib.sap_pairs(
            boxes, n, mask_ptr,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), count)
    LAST_PATH = "cpp"
    pairs = out[:count]
    # canonical ordering for deterministic output
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def _sap_pairs_numpy(aabbs, mask=None):
    """NumPy all-pairs version (same output contract)."""
    n = aabbs.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    lo_i, hi_i = aabbs[iu, :2], aabbs[iu, 2:]
    lo_j, hi_j = aabbs[ju, :2], aabbs[ju, 2:]
    ok = np.all((lo_i <= hi_j) & (lo_j <= hi_i), axis=-1)
    if mask is not None:
        mask = np.asarray(mask, bool)
        ok &= mask[iu] & mask[ju]
    return np.stack([iu[ok], ju[ok]], axis=-1).astype(np.int32)
