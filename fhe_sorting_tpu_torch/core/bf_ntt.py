"""K2: the merged-twiddle butterfly NTT as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel `fhe_sorting_tpu/core/pallas_ntt.py:kernel`
(see `csrc/bf_ntt.cu` for the design).  `butterfly` is the only entry:

  * a tensor on the CPU runs the plain PyTorch version
    (`ntt.butterfly_plain`), which is what the CPU tests exercise;
  * a tensor on a CUDA device launches the kernel once on the current
    stream, or raises.  Nothing falls back.

One launch transforms every plane: a thread-block cluster of 2^c blocks holds
a plane in shared memory, block b the residues [b m, (b+1) m) with m = n / 2^c.
The first c stages (the last c of the inverse) run in registers between
device memory and the blocks' shared memory; the others run inside each
block as rounds of a few stages in registers.  Where every prime of the
tables is below 2^30 (`NttTables.lazy`) the butterflies keep residues in
[0, 4p) and correct them once on the way out.  `cluster_log(logn)` is c: a
block holds 2^14 residues where the ring has as many.  The kernel is
compiled with nvcc at first use (`core/cuda_build.py`), which counts its
launches as `k2`.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .ntt import NttTables, butterfly_plain

LOG_CHUNK = 14         # residues a block holds: 2^14 u32 = 64 KB (+ padding)
MAX_LOG_CLUSTER = 3    # 8 blocks: the portable cluster size


def load():
    """Build (once per source version) and load the kernel library."""
    lib = cuda_build.load("bf_ntt")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bf_ntt_transform.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
    lib.bf_ntt_transform.restype = ci
    lib.bf_ntt_max_active_clusters.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
    lib.bf_ntt_max_active_clusters.restype = ci
    return lib


def max_active_clusters(logn: int, c: int, lazy: bool = True) -> int:
    """`cudaOccupancyMaxActiveClusters` for ring 2^logn on clusters of 2^c
    blocks: the planes the current card transforms at once."""
    got = ctypes.c_int(0)
    rc = load().bf_ntt_max_active_clusters(logn, c, int(lazy), ctypes.byref(got))
    if rc != 0:
        raise RuntimeError(f"bf_ntt_max_active_clusters({logn}, {c}) failed: CUDA error {rc}")
    return got.value


def cluster_log(logn: int) -> int:
    """log2 of the cluster size for ring 2^logn: one block up to 2^14
    residues, above that as many blocks of 2^14 as the plane fills."""
    c = max(0, logn - LOG_CHUNK)
    if c > MAX_LOG_CLUSTER:
        raise ValueError(f"butterfly kernel: ring 2^{logn} does not fit a cluster")
    return c


def _check(x: torch.Tensor, t: NttTables, limbs: torch.Tensor):
    B, L, n = x.shape
    if x.dtype != torch.int64 or not x.is_contiguous():
        raise ValueError("butterfly: data must be contiguous int64 [B, L, n]")
    if n < 2 or n & (n - 1) or t.psi_rev.shape[-1] != n:
        raise ValueError(f"butterfly: ring {n} does not match the tables")
    if limbs.dtype != torch.int64 or limbs.shape != (L,) or not limbs.is_contiguous():
        raise ValueError("butterfly: limbs must be a contiguous int64 vector of length L")
    for name in ("p", "n_inv", "psi_pack", "ipsi_pack", "limbs"):
        ten = limbs if name == "limbs" else getattr(t, name)
        if ten.device != x.device or ten.dtype != torch.int64 or not ten.is_contiguous():
            raise ValueError(f"butterfly: {name} must be contiguous int64 on {x.device}")


def _launch(x: torch.Tensor, t: NttTables, limbs: torch.Tensor, inverse: bool, c: int):
    """One launch on checked arguments, with clusters of 2^c blocks."""
    B, L, n = x.shape
    tw = t.ipsi_pack if inverse else t.psi_pack
    out = torch.empty_like(x)
    cuda_build.launch("k2", load().bf_ntt_transform, x.data_ptr(), out.data_ptr(), tw.data_ptr(),
                      t.p.data_ptr(), t.n_inv.data_ptr(), limbs.data_ptr(), n.bit_length() - 1,
                      c, L, B * L, int(inverse), int(t.lazy), device=x.device)
    return out


def butterfly(x: torch.Tensor, t: NttTables, limbs, inverse: bool) -> torch.Tensor:
    """Negacyclic butterfly NTT (or its inverse) of x [B, L, n] int64;
    `limbs` (int64 [L] or None for all) indexes the tables' limbs."""
    if x.device.type == "cpu":
        return butterfly_plain(x, t, limbs, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"butterfly: unsupported device {x.device}")
    if limbs is None:
        limbs = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    _check(x, t, limbs)
    return _launch(x, t, limbs, inverse, cluster_log(x.shape[-1].bit_length() - 1))
