"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes``.  The library is built at its
first use, into ``build/`` inside this package, under a name keyed by a hash
of the sources and the compiler flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing here runs at import time.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
# sm_90a: Hopper with its architecture-specific features.  No
# --use_fast_math: the IPM relies on exact divisions and its 1e-30/1e-20
# guards.  --split-compile=0 runs the optimizer on every CPU: the fused
# IPM kernel's 16 unrolled instances take ~3x longer to build without it.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--split-compile=0")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()                  # guards _locks
_locks: dict[str, threading.Lock] = {}    # one per library: builds overlap


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _source_key(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def load(name) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    Thread-safe; libraries of different sources build concurrently."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = BUILD / f"lib{name}_{_source_key(name)}.so"
        if not out.exists():
            BUILD.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
            os.close(fd)
            try:
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                       str(CSRC / f"{name}.cu")]
                res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {name}.cu:\n{res.stderr}")
                os.replace(tmp, out)   # atomic: never a half-written .so
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(out))
        lib.lcp_error_string.argtypes = [ctypes.c_int]
        lib.lcp_error_string.restype = ctypes.c_char_p
        lib.lcp_set_device.argtypes = [ctypes.c_int]
        lib.lcp_set_device.restype = ctypes.c_int
        _libs[name] = lib
        return lib


def load_all():
    """Build where needed and load every ``csrc/*.cu`` library at once, one
    nvcc per source; returns the library names."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(load, names))
    return names


def check(lib, code, what):
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.lcp_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptr(t):
    """A tensor's device address for a ctypes ``c_void_p`` argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(lib, device):
    """Select ``device`` in the library's runtime and return its current
    PyTorch stream as a ``c_void_p``."""
    import torch

    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    check(lib, lib.lcp_set_device(index), "cudaSetDevice")
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
