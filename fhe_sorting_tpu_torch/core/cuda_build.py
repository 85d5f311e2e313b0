"""Build and load the package's CUDA sources (`csrc/*.cu`).

Each source is compiled by nvcc for `sm_90a` into a shared library with a
plain C interface, at first use, into `_build/` beside the package (named by
the source's hash, so an edited source rebuilds), and loaded with ctypes.
`build` starts one nvcc per missing library, all together, and waits for
them; `load` builds its library if it is missing.  `reports[name]` keeps
(seconds, nvcc's `-Xptxas -v` output) of the builds this process made.

`KERNELS` registers the package's hand-written kernels under the keys the
dispatch spans count them by (`k1` to `k4`), each with its source and its
device functions (the names a profiler shows).  Every wrapper launches
through `launch`, which counts each launch under its kernel's key;
`counts()` reads the counter, `reset()` sets it to 0 and `advance(delta)`
adds (or, negative, takes back) launches a replayed graph (or its capture)
ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_libs: dict = {}
reports: dict = {}     # name -> (build seconds, nvcc report)


@dataclass(frozen=True)
class Kernel:
    source: str            # csrc/<source>.cu, and the wrapper core/<source>.py
    functions: tuple       # its __global__ functions


KERNELS = {
    "k1": Kernel("fs_ntt", ("modmm_kernel",)),
    "k2": Kernel("bf_ntt", ("bf_cluster_kernel",)),
    "k3": Kernel("rns_div", ("rns_lift_kernel", "rns_sub_scale_kernel")),
    "k4": Kernel("rns_bconv", ("rns_bconv_kernel",)),
}

_launches = dict.fromkeys(KERNELS, 0)


def counts() -> dict:
    """{key: launches} of every registered kernel so far."""
    return dict(_launches)


def reset() -> None:
    for key in _launches:
        _launches[key] = 0


def advance(delta: dict, sign: int = 1) -> None:
    """Add `sign` times the launches `delta` ({key: n}) to the counter."""
    for key, n in delta.items():
        _launches[key] += sign * n


def since(before: dict) -> dict:
    """{key: launches} since the snapshot `before` (a `counts()`)."""
    return {key: n - before[key] for key, n in _launches.items()}


def launch(key: str, entry, *args, device) -> None:
    """`entry(*args, stream)`, a ctypes entry of kernel `key` that returns a
    CUDA error code, on `device` and its current stream; raises where the
    code is not 0, and counts one launch where it is."""
    with torch.cuda.device(device):
        rc = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{key.upper()} ({KERNELS[key].source}): {entry.__name__} launch "
                           f"failed: CUDA error {rc}")
    _launches[key] += 1


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _paths(name: str):
    src = os.path.join(_PKG, "csrc", f"{name}.cu")
    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    return src, os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")


def build(names) -> None:
    """Compile every named source whose library is missing, in parallel."""
    jobs = []
    for name in names:
        src, so = _paths(name)
        if os.path.exists(so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, so, tmp, proc, time.time()))
    for name, so, tmp, proc, t0 in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{err}")
        os.replace(tmp, so)
        reports[name] = (time.time() - t0, err)


def load(name: str) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu`, built first if it is missing."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(_paths(name)[1])
        return _libs[name]
