"""K1: the four-step NTT as a hand-written CUDA kernel, and its wrapper.

Replaces the Pallas TPU kernel `fhe_sorting_tpu/core/pallas_fs_ntt.py:_kernel`
(see `csrc/fs_ntt.cu` for the design).  `four_step` is the only entry:

  * a tensor on the CPU runs the plain PyTorch version
    (`ntt_mxu.ntt_plain`), which is what the CPU tests exercise;
  * a tensor on a CUDA device launches the kernel twice (the two matmul
    passes) on the current stream, or raises.  Nothing falls back.

The kernel multiplies s8 digit planes on the tensor cores; it reads the
tables' kernel-side copy (`FourStepTables.kern`: digit planes and packed
twiddles, made once at table build).  The intermediate between the two
launches is the kernel's own, u32 residues.  The kernel is compiled with
nvcc at first use (`core/cuda_build.py`), which counts its launches as `k1`.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .ntt_mxu import INT64_TABLES, FourStepTables, ntt_plain

_TILE = 64          # n1 and n2 must be multiples of the kernel's smallest table tile
_MAX_K = 512        # the deepest product whose digit sums the kernel proves to fit s32


def load():
    """Build (once per source version) and load the kernel library."""
    lib = cuda_build.load("fs_ntt")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fs_modmm.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.fs_modmm.restype = ci
    return lib


def _check(x: torch.Tensor, t: FourStepTables, limbs: torch.Tensor):
    B, L, n1, n2 = x.shape
    if x.dtype != torch.int64 or not x.is_contiguous():
        raise ValueError("four_step: data must be contiguous int64 [B, L, n1, n2]")
    if n1 != t.n1 or t.w2f.shape[-1] != n2:
        raise ValueError(f"four_step: data [{n1}, {n2}] does not match the tables")
    if n1 % _TILE or n2 % _TILE or max(n1, n2) > _MAX_K:
        raise ValueError(f"four_step kernel needs n1, n2 multiples of {_TILE}, at most {_MAX_K}")
    if limbs.dtype != torch.int64 or limbs.shape != (L,) or not limbs.is_contiguous():
        raise ValueError("four_step: limbs must be a contiguous int64 vector of length L")
    for name in INT64_TABLES:
        ten = getattr(t, name)
        if ten.device != x.device or ten.dtype != torch.int64 or not ten.is_contiguous():
            raise ValueError(f"four_step: table {name} must be contiguous int64 on {x.device}")
    if x.device.type == "cuda" and t.kern is None:
        raise ValueError("four_step: the tables have no kernel-side copy "
                         "(build them on the CUDA device with build_fs_tables)")
    if limbs.device != x.device:
        raise ValueError("four_step: limbs must lie on the data's device")


def _launch(lib, data, tab, out, tw, mods, limbs, M, N, K, batch, data_a, first):
    cuda_build.launch("k1", lib.fs_modmm, data.data_ptr(), tab.data_ptr(), out.data_ptr(),
                      tw.data_ptr() if tw is not None else None,
                      mods.data_ptr(), limbs.data_ptr(), M, N, K, limbs.shape[0],
                      batch, data_a, first, device=out.device)


def four_step(x: torch.Tensor, t: FourStepTables, limbs, inverse: bool) -> torch.Tensor:
    """Negacyclic four-step NTT (or its inverse) of x [B, L, n1, n2] int64;
    `limbs` (int64 [L] or None for all) indexes the tables' limbs."""
    if x.device.type == "cpu":
        return ntt_plain(x, t, limbs, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"four_step: unsupported device {x.device}")
    B, L, n1, n2 = x.shape
    if limbs is None:
        limbs = torch.arange(L, dtype=torch.int64, device=x.device)
    _check(x, t, limbs)
    lib = load()
    k = t.kern
    mid = torch.empty(x.shape, dtype=torch.int32, device=x.device)   # u32 residues
    out = torch.empty_like(x)
    if not inverse:
        # V = (W1 @ X) * T, then Y = V @ W2
        _launch(lib, x, k.w1f, mid, k.tf, k.mods, limbs, n1, n2, n1, B, 0, 1)
        _launch(lib, mid, k.w2f, out, None, k.mods, limbs, n1, n2, n2, B, 1, 0)
    else:
        # S = (X @ W2i) * Ti, then Y = W1i @ S
        _launch(lib, x, k.w2i, mid, k.ti, k.mods, limbs, n1, n2, n2, B, 1, 1)
        _launch(lib, mid, k.w1i, out, None, k.mods, limbs, n1, n2, n1, B, 0, 0)
    return out
