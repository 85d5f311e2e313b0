"""K4: the key switch's RNS base extension as a hand-written CUDA kernel.

Replaces no TPU kernel (see `csrc/rns_bconv.cu` for why it exists and its
design).  ModUp extends every digit of the coefficient planes into the
target basis, ModDown the special rows into the active ones; both are the
fast base conversion

  out[b D + d, t] = sum_{lo <= i < hi} fac[t, i] (x[b, i] hat_i mod pin_i)
                    mod pout_t

for batch b and digit d = (lo, hi) of `digits`: `base_extend(x, hat, pin,
fac, pout, digits)` with x [B, R, n], hat and pin [R, 1], fac [T, R] (digit
d's factors in its columns lo:hi), pout [T, 1], and out [B D, T, n].  ModUp
passes its [1, Ll, n] planes with the level's digits (out [D, T, n], the
planes the NTT takes next), ModDown its [2, K, n] planes with one digit.

Each call runs by where its tensor lies:

  * a tensor on the CPU runs the plain PyTorch version (`base_extend_plain`:
    the evaluator's expressions before K4, `mulmod` and `mod_matmul` a
    digit, stacked), which is what the CPU tests exercise;
  * a tensor on a CUDA device launches the kernel once on the current
    stream, or raises.  Nothing falls back.

Zero target rows (a limb rank that owns none) launch nothing.  The kernel is
compiled with nvcc at first use (`core/cuda_build.py`), which counts its
launches as `k4`.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .modmath import mulmod
from .ntt_mxu import mod_matmul
from .rns_div import check_rows


def load():
    """Build (once per source version) and load the kernel library."""
    lib = cuda_build.load("rns_bconv")
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rns_bconv.argtypes = [vp] * 7 + [ci] * 5 + [cl] * 6 + [vp]
    lib.rns_bconv.restype = ci
    return lib


def base_extend_plain(x: torch.Tensor, hat, pin, fac: torch.Tensor, pout, digits) -> torch.Tensor:
    y = mulmod(x, hat, pin)
    ext = torch.stack([mod_matmul(fac[:, lo:hi], y[:, lo:hi], pout) for lo, hi in digits], dim=1)
    return ext.flatten(0, 1)


def _bounds(digits, R: int) -> list:
    """The D + 1 bounds of consecutive digits (lo, hi) inside R rows."""
    bounds = [digits[0][0]]
    for lo, hi in digits:
        if lo != bounds[-1] or hi <= lo:
            raise ValueError(f"rns_bconv: digits {list(digits)} must be consecutive and non-empty")
        bounds.append(hi)
    if bounds[0] < 0 or bounds[-1] > R:
        raise ValueError(f"rns_bconv: digits {list(digits)} exceed the {R} rows of x")
    return bounds


def base_extend(x: torch.Tensor, hat: torch.Tensor, pin: torch.Tensor, fac: torch.Tensor,
                pout: torch.Tensor, digits) -> torch.Tensor:
    """[B D, T, n]: the digits (lo, hi) of x [B, R, n] (residues mod pin
    [R, 1]) times their hat-inverses `hat` [R, 1], extended by the factors
    fac [T, R] into the T rows with primes pout [T, 1]."""
    if x.device.type == "cpu":
        return base_extend_plain(x, hat, pin, fac, pout, digits)
    if x.device.type != "cuda":
        raise ValueError(f"rns_bconv: unsupported device {x.device}")
    dev = x.device
    if x.dtype != torch.int64 or x.dim() != 3:
        raise ValueError(f"rns_bconv: x must be int64 [B, R, n], not {x.dtype} {tuple(x.shape)}")
    B, R, n = x.shape
    T, D = fac.shape[0], len(digits)
    bounds = _bounds(digits, R)
    out = torch.empty((B * D, T, n), dtype=torch.int64, device=dev)
    if T == 0:
        return out
    if ((x.stride(2) != 1 and n > 1) or x.stride(0) % 2 or x.stride(1) % 2
            or x.data_ptr() % 16):
        raise ValueError(f"rns_bconv: x needs unit column steps and even batch and row strides "
                         f"from a 16-byte boundary (strides {x.stride()})")
    if fac.dtype != torch.int64 or fac.device != dev or fac.shape != (T, R) or (
            fac.stride(1) != 1 and R > 1):
        raise ValueError(f"rns_bconv: fac must be int64 [{T}, {R}] on {dev} with unit column "
                         f"steps, not {fac.dtype} {tuple(fac.shape)} {fac.stride()} on "
                         f"{fac.device}")
    check_rows("rns_bconv", "hat", hat, dev, R)
    check_rows("rns_bconv", "pin", pin, dev, R)
    check_rows("rns_bconv", "pout", pout, dev, T)
    cuda_build.launch(
        "k4", load().rns_bconv, x.data_ptr(), hat.data_ptr(), pin.data_ptr(), fac.data_ptr(),
        pout.data_ptr(), out.data_ptr(), (ctypes.c_int * (D + 1))(*bounds), D, B, T, R, n,
        x.stride(0), x.stride(1), hat.stride(0), pin.stride(0), fac.stride(0), pout.stride(0),
        device=dev)
    return out
