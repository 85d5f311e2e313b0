"""K1: the four-step NTT as a hand-written CUDA kernel, and its wrapper.

Replaces the Pallas TPU kernel `fhe_sorting_tpu/core/pallas_fs_ntt.py:_kernel`
(see `csrc/fs_ntt.cu` for the design).  `four_step` is the only entry:

  * a tensor on the CPU runs the plain PyTorch version
    (`ntt_mxu.ntt_plain`), which is what the CPU tests exercise;
  * a tensor on a CUDA device launches the kernel twice (the two matmul
    passes) on the current stream, or raises.  Nothing falls back.

The kernel is compiled with nvcc at first use (`core/cuda_build.py`).
`launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import fields

import torch

from . import cuda_build
from .ntt_mxu import FourStepTables, ntt_plain

_TILE = 64          # the kernel's output tile (rows and cols)

launches = 0


def load():
    """Build (once per source version) and load the kernel library."""
    lib = cuda_build.load("fs_ntt")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fs_modmm.argtypes = [vp, ci, vp, ci, vp, vp, vp, vp, vp,
                             ci, ci, ci, ci, ci, vp]
    lib.fs_modmm.restype = ci
    return lib


def _check(x: torch.Tensor, t: FourStepTables, limbs: torch.Tensor):
    B, L, n1, n2 = x.shape
    if x.dtype != torch.int64 or not x.is_contiguous():
        raise ValueError("four_step: data must be contiguous int64 [B, L, n1, n2]")
    if n1 != t.n1 or t.w2f.shape[-1] != n2:
        raise ValueError(f"four_step: data [{n1}, {n2}] does not match the tables")
    if n1 % _TILE or n2 % _TILE:
        raise ValueError(f"four_step kernel needs n1, n2 multiples of {_TILE}")
    if limbs.dtype != torch.int64 or limbs.shape != (L,) or not limbs.is_contiguous():
        raise ValueError("four_step: limbs must be a contiguous int64 vector of length L")
    for f in fields(t):
        ten = getattr(t, f.name)
        if ten.device != x.device or ten.dtype != torch.int64 or not ten.is_contiguous():
            raise ValueError(f"four_step: table {f.name} must be contiguous int64 on {x.device}")
    if limbs.device != x.device:
        raise ValueError("four_step: limbs must lie on the data's device")


def _launch(lib, a, a_tab, b, b_tab, c, tw, tw_sh, t, limbs, M, N, K, batch):
    global launches
    rc = lib.fs_modmm(a.data_ptr(), a_tab, b.data_ptr(), b_tab, c.data_ptr(),
                      tw.data_ptr() if tw is not None else None,
                      tw_sh.data_ptr() if tw_sh is not None else None,
                      t.p.data_ptr(), limbs.data_ptr(), M, N, K, limbs.shape[0],
                      batch, torch.cuda.current_stream(c.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fs_modmm launch failed: CUDA error {rc}")
    launches += 1


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
    mid = torch.empty_like(x)
    out = torch.empty_like(x)
    if not inverse:
        # V = (W1 @ X) * T, then Y = V @ W2
        _launch(lib, t.w1f, 1, x, 0, mid, t.tf, t.tf_sh, t, limbs, n1, n2, n1, B)
        _launch(lib, mid, 0, t.w2f, 1, out, None, None, t, limbs, n1, n2, n2, B)
    else:
        # S = (X @ W2i) * Ti, then Y = W1i @ S
        _launch(lib, x, 0, t.w2i, 1, mid, t.ti, t.ti_sh, t, limbs, n1, n2, n2, B)
        _launch(lib, t.w1i, 1, mid, 0, out, None, None, t, limbs, n1, n2, n1, B)
    return out
