"""K3: the exact division by a dropped modulus as a hand-written CUDA kernel.

Replaces no TPU kernel (see `csrc/rns_div.cu` for why it exists and its
design).  A rescale divides by the prime q_last it drops, ModDown by the
special product P; both are an exact division in RNS with the same two
elementwise halves around an NTT, and both call this module with their own
constants, the rows' primes p and constants [r, 1] the context already
keeps (`RescaleRows`, `KeySwitchRows`), views included:

  * `lift(x, p, c, half)`: the dropped limb's coefficients x [B, 1, n] in
    [0, q) onto each kept prime, centred: x mod p_i, less c_i = q mod p_i
    where x >= half = ceil(q / 2);
  * `sub_scale(a, b, p, w)`: (a - b) w mod p, row by row, with
    w_i = q^-1 mod p_i; `a` may be a view of the kept rows of larger planes
    ([B, r, n] with any even batch stride, rows n apart), read in place.

Each entry runs by where its tensor lies:

  * a tensor on the CPU runs the plain PyTorch version (`lift_plain`,
    `sub_scale_plain`: the expressions the evaluator used before K3), which
    is what the CPU tests exercise;
  * a tensor on a CUDA device launches the kernel once on the current
    stream, or raises.  Nothing falls back.

Zero rows (a limb rank that owns none) launch nothing.  The kernel is
compiled with nvcc at first use (`core/cuda_build.py`), which counts its
launches as `k3`.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .modmath import mulmod, sub_mod


def load():
    """Build (once per source version) and load the kernel library."""
    lib = cuda_build.load("rns_div")
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rns_lift.argtypes = [vp, vp, vp, vp, cl, ci, ci, ci, cl, cl, cl, vp]
    lib.rns_lift.restype = ci
    lib.rns_sub_scale.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, cl, cl, cl, cl, vp]
    lib.rns_sub_scale.restype = ci
    return lib


def lift_plain(x: torch.Tensor, p, c, half: int) -> torch.Tensor:
    xm = torch.remainder(x, p)
    return torch.where(x >= half, sub_mod(xm, c, p), xm)


def sub_scale_plain(a: torch.Tensor, b: torch.Tensor, p, w) -> torch.Tensor:
    return mulmod(sub_mod(a, b, p), w, p)


def _check_planes(name: str, t: torch.Tensor, dev, rows: int, n: int):
    """A [B, rows, n] int64 operand on `dev` whose rows lie n apart, with
    unit steps and an even batch stride from a 16-byte boundary."""
    if t.dtype != torch.int64 or t.device != dev or t.dim() != 3 or t.shape[1:] != (rows, n):
        raise ValueError(f"rns_div: {name} must be int64 [B, {rows}, {n}] on {dev}, "
                         f"not {t.dtype} {tuple(t.shape)} on {t.device}")
    if ((t.stride(2) != 1 and n > 1) or (t.stride(1) != n and rows > 1) or t.stride(0) % 2
            or t.data_ptr() % 16):
        raise ValueError(f"rns_div: {name} needs rows n apart, unit steps and an even batch "
                         f"stride from a 16-byte boundary (strides {t.stride()})")


def check_rows(who: str, name: str, t: torch.Tensor, dev, rows: int):
    """One int64 constant a row on `dev`: [rows, 1] (any row stride); `who`
    names the caller in the message."""
    if t.dtype != torch.int64 or t.device != dev or t.shape != (rows, 1):
        raise ValueError(f"{who}: {name} must be int64 [{rows}, 1] on {dev}, "
                         f"not {t.dtype} {tuple(t.shape)} on {t.device}")


def _device(x: torch.Tensor) -> bool:
    """Whether `x` runs the kernel (True) or the plain version (False)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"rns_div: unsupported device {x.device}")
    return True


def lift(x: torch.Tensor, p: torch.Tensor, c: torch.Tensor, half: int) -> torch.Tensor:
    """t [B, r, n]: the coefficients x [B, 1, n] (in [0, q)) centred onto
    the r rows with primes p and c = q mod p [r, 1], `half` = ceil(q / 2)."""
    if not _device(x):
        return lift_plain(x, p, c, half)
    if x.dim() != 3:
        raise ValueError(f"rns_div: x must be [B, 1, n], not {tuple(x.shape)}")
    B, n, r = x.shape[0], x.shape[-1], p.shape[0]
    out = torch.empty((B, r, n), dtype=torch.int64, device=x.device)
    if r == 0:
        return out
    _check_planes("x", x, x.device, 1, n)
    check_rows("rns_div", "p", p, x.device, r)
    check_rows("rns_div", "c", c, x.device, r)
    cuda_build.launch("k3", load().rns_lift, x.data_ptr(), out.data_ptr(), p.data_ptr(),
                      c.data_ptr(), half, B, r, n, x.stride(0), p.stride(0), c.stride(0),
                      device=x.device)
    return out


def sub_scale(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(a - b) w mod p [B, r, n] for residues a, b of the rows with primes p
    and multipliers w [r, 1]."""
    if not _device(a):
        return sub_scale_plain(a, b, p, w)
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rns_div: a {tuple(a.shape)} and b {tuple(b.shape)} must both be "
                         f"[B, r, n]")
    B, r, n = a.shape
    out = torch.empty((B, r, n), dtype=torch.int64, device=a.device)
    if r == 0:
        return out
    _check_planes("a", a, a.device, r, n)
    _check_planes("b", b, a.device, r, n)
    check_rows("rns_div", "p", p, a.device, r)
    check_rows("rns_div", "w", w, a.device, r)
    cuda_build.launch("k3", load().rns_sub_scale, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                      p.data_ptr(), w.data_ptr(), B, r, n, a.stride(0), b.stride(0),
                      p.stride(0), w.stride(0), device=a.device)
    return out
