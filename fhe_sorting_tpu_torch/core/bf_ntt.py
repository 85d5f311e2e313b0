"""K2: the merged-twiddle butterfly NTT as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel `fhe_sorting_tpu/core/pallas_ntt.py:kernel`
(see `csrc/bf_ntt.cu` for the design).  `butterfly` is the only entry:

  * a tensor on the CPU runs the plain PyTorch version
    (`ntt.butterfly_plain`), which is what the CPU tests exercise;
  * a tensor on a CUDA device launches the kernel once per pass of
    `passes(logn)` on the current stream, or raises.  Nothing falls back.

A pass runs the butterfly stages [s0, s1) on tiles of 2^(s1-s0) rows of
2^logT adjacent residues held in shared memory; `passes` cuts the log2(n)
stages into as few passes as the tile allows.  The kernel is compiled with
nvcc at first use (`core/cuda_build.py`).  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .ntt import NttTables, butterfly_plain

LOG_TILE = 13      # residues a block holds in shared memory (32 KB as u32)
LOG_CONTIG = 11    # stages of the last forward pass when n exceeds one tile
LOG_ROWS = 9       # most stages of a strided pass (rows of >= 16 residues)

launches = 0


def passes(logn: int) -> list:
    """[(s0, s1, logT)] in forward order: stages [s0, s1) on tiles of
    2^(s1-s0) rows of 2^logT adjacent residues."""
    if logn <= LOG_TILE:
        return [(0, logn, 0)]
    head = logn - LOG_CONTIG
    out = []
    s = 0
    while s < head:
        s1 = min(head, s + LOG_ROWS)
        out.append((s, s1, min(logn - s1, LOG_TILE - (s1 - s))))
        s = s1
    out.append((head, logn, 0))
    return out


def load():
    """Build (once per source version) and load the kernel library."""
    lib = cuda_build.load("bf_ntt")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bf_ntt_pass.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.bf_ntt_pass.restype = ci
    return lib


def _check(x: torch.Tensor, t: NttTables, limbs: torch.Tensor):
    B, L, n = x.shape
    if x.dtype != torch.int64 or not x.is_contiguous():
        raise ValueError("butterfly: data must be contiguous int64 [B, L, n]")
    if n < 2 or n & (n - 1) or t.psi_rev.shape[-1] != n:
        raise ValueError(f"butterfly: ring {n} does not match the tables")
    if limbs.dtype != torch.int64 or limbs.shape != (L,) or not limbs.is_contiguous():
        raise ValueError("butterfly: limbs must be a contiguous int64 vector of length L")
    for name in ("p", "n_inv", "psi_rev", "ipsi_rev", "limbs"):
        ten = limbs if name == "limbs" else getattr(t, name)
        if ten.device != x.device or ten.dtype != torch.int64 or not ten.is_contiguous():
            raise ValueError(f"butterfly: {name} must be contiguous int64 on {x.device}")


def butterfly(x: torch.Tensor, t: NttTables, limbs, inverse: bool) -> torch.Tensor:
    """Negacyclic butterfly NTT (or its inverse) of x [B, L, n] int64;
    `limbs` (int64 [L] or None for all) indexes the tables' limbs."""
    global launches
    if x.device.type == "cpu":
        return butterfly_plain(x, t, limbs, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"butterfly: unsupported device {x.device}")
    B, L, n = x.shape
    if limbs is None:
        limbs = torch.arange(L, dtype=torch.int64, device=x.device)
    _check(x, t, limbs)
    lib = load()
    logn = n.bit_length() - 1
    plan = passes(logn)
    if inverse:
        plan = plan[::-1]
    tw = t.ipsi_rev if inverse else t.psi_rev
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    src = x
    for i, (s0, s1, log_t) in enumerate(plan):
        scale = int(inverse and i == len(plan) - 1)
        rc = lib.bf_ntt_pass(src.data_ptr(), out.data_ptr(), tw.data_ptr(),
                             t.p.data_ptr(), t.n_inv.data_ptr(), limbs.data_ptr(),
                             logn, s0, s1, log_t, L, B * L, int(inverse), scale, stream)
        if rc != 0:
            raise RuntimeError(f"bf_ntt_pass launch failed: CUDA error {rc}")
        launches += 1
        src = out
    return out
