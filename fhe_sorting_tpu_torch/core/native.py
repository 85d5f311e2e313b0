"""ctypes loader for the native host kernels (`native/fhe_host.cpp`).

The port's own copy of `fhe_sorting_tpu/core/native.py`.  The library is
built with g++ at first use into the package's `_build/` directory (named
by the source's hash); every entry point has a numpy fallback in its caller
(`core/ntt.py`, `core/encoding.py`), so the package works without a
toolchain or without the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "fhe_host.cpp")
_BUILD = os.path.join(_PKG, "_build")


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            with open(_SRC, "rb") as f:
                tag = hashlib.sha1(f.read()).hexdigest()[:12]
            so = os.path.join(_BUILD, f"libfhehost_{tag}.so")
            if not os.path.exists(so):
                os.makedirs(_BUILD, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", tmp],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.SubprocessError):
            return None      # no source or no g++: callers use numpy
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.host_ntt_batch.argtypes = [u64p, u64p, ctypes.c_uint64,
                                       ctypes.c_long, ctypes.c_long]
        lib.host_intt_batch.argtypes = [u64p, u64p, ctypes.c_uint64,
                                        ctypes.c_uint64, ctypes.c_long,
                                        ctypes.c_long]
        lib.garner_digits.argtypes = [u64p, ctypes.c_long, ctypes.c_long,
                                      u64p, u64p, u64p, u64p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def ntt_batch(data: np.ndarray, psi_rev: np.ndarray, p: int) -> np.ndarray:
    """Forward NTT over rows; returns a new array.  data: [batch, n] u64."""
    lib = _load()
    out = np.ascontiguousarray(data, dtype=np.uint64).copy()
    psi = np.ascontiguousarray(psi_rev, dtype=np.uint64)
    lib.host_ntt_batch(_ptr(out), _ptr(psi), p, out.shape[-1],
                       out.reshape(-1, out.shape[-1]).shape[0])
    return out


def intt_batch(data: np.ndarray, ipsi_rev: np.ndarray, n_inv: int,
               p: int) -> np.ndarray:
    lib = _load()
    out = np.ascontiguousarray(data, dtype=np.uint64).copy()
    psi = np.ascontiguousarray(ipsi_rev, dtype=np.uint64)
    lib.host_intt_batch(_ptr(out), _ptr(psi), n_inv, p, out.shape[-1],
                        out.reshape(-1, out.shape[-1]).shape[0])
    return out


def garner(res: np.ndarray, primes, minv: np.ndarray,
           pm: np.ndarray) -> np.ndarray:
    """Mixed-radix digits; res [L, n] u64 -> v [L, n] u64."""
    lib = _load()
    L, n = res.shape
    res_c = np.ascontiguousarray(res, dtype=np.uint64)
    pr = np.ascontiguousarray(np.asarray(primes, dtype=np.uint64))
    mi = np.ascontiguousarray(minv, dtype=np.uint64)
    pmc = np.ascontiguousarray(pm, dtype=np.uint64)
    out = np.zeros((L, n), dtype=np.uint64)
    lib.garner_digits(_ptr(res_c), L, n, _ptr(pr), _ptr(mi), _ptr(pmc),
                      _ptr(out))
    return out
