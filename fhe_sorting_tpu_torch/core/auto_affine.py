"""Galois automorphisms as matrix products (no gather).

Port of `fhe_sorting_tpu/core/auto_affine.py`.  The evaluator applies
sigma_g in the evaluation domain as the gather `data[..., perm]`; this module
computes the same permutation with matrix products only.

In NATURAL evaluation order (position k holds the evaluation at
zeta^{2k+1}), sigma_g is the affine index map

    out[k] = in[(g*k + c) mod n],   c = (g-1)/2.

On the four-step [n1 (rows), n2 (lanes)] grid, with k_lo = k mod n1 on the
row axis and k_hi = k div n1 on the lane axis, the map factors:

    src_lo = (g*k_lo + c) mod n1                  -> a row permutation
    src_hi = (g*k_hi + t(k_lo)) mod n2,
      t(k_lo) = ((g*k_lo + c) - src_lo)/n1        -> a lane stride-g map
                                                     and a per-row lane roll

and the per-row roll by a(k_lo) = g^{-1} t(k_lo) mod n2 is diagonal in the
mod-p DFT of order n2 (omega a primitive n2-th root mod p, which exists
because n2 | n | (p-1)/2):

    roll_a = F^{-1} . diag(omega^{-r a}) . F

Storage stays bit-reversed: every constant matrix is conjugated by the
bit-reversal of its axis when it is built.  The automorphism is then five
steps, each exact:

    x -> R_g x          one-hot row product
      -> x Lam_g        one-hot lane product
      -> x F_br^T       mod-p product over the lanes
      -> * T_g          T = W @ onehot_a (a one-hot product), elementwise
      -> x F_br^-T      mod-p product over the lanes, 1/n2 folded in

and the result is bit-identical to the gather.  Residues are int64 below
2^31.  The one-hot products run as float64 matrix products on the residues,
exact because every output sums one nonzero term below 2^31; the two DFTs
run as `ntt_mxu.mod_matmul`'s 16-bit-half float64 products, exact for
n2 < 2^21, against the tables' halves split once when the tables are built.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from . import primes as primes_mod
from .modmath import mulmod
from .ntt import pow_table
from .ntt_mxu import mod_matmul_halves, split_halves


def _bitrev(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@dataclass(frozen=True)
class AffineAutoTables:
    """Per-limb tables, independent of g, on one device.  `fb`, `fib` and
    `wneg` are int64 residues; the other fields are their float64 forms as
    the products read them: the 16-bit halves of the transposed DFTs and W
    itself (exact in float64)."""

    p: torch.Tensor         # [L, 1, 1]
    fb: torch.Tensor        # [L, n2, n2]  F_br[r, j2] = w^{r * r2(j2)}
    fib: torch.Tensor       # [L, n2, n2]  F_br^{-1}[j2, r] = w^{-r2(j2) r} / n2
    wneg: torch.Tensor      # [L, n2, n2]  W[r, s] = w^{-r s}
    fbt_lo: torch.Tensor    # [L, n2, n2] float64, halves of fb^T
    fbt_hi: torch.Tensor
    fibt_lo: torch.Tensor   # [L, n2, n2] float64, halves of fib^T
    fibt_hi: torch.Tensor
    wneg_f: torch.Tensor    # [L, n2, n2] float64

    def _map(self, fn) -> "AffineAutoTables":
        return AffineAutoTables(*(fn(getattr(self, f.name)) for f in fields(self)))

    def slice(self, lo: int, hi: int) -> "AffineAutoTables":
        """Limbs lo..hi-1 (views)."""
        return self._map(lambda t: t[lo:hi])

    def take(self, idx) -> "AffineAutoTables":
        """The limbs at host indices `idx` (a gathered copy)."""
        idx = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=self.p.device)
        return self.select(idx)

    def select(self, limbs: torch.Tensor | None) -> "AffineAutoTables":
        """The limbs of an index tensor on the tables' device, such as
        `Context.active_limbs(level)` (a gathered copy; None: all)."""
        if limbs is None:
            return self
        return self._map(lambda t: t.index_select(0, limbs))

    def nbytes(self) -> int:
        return sum(getattr(self, f.name).numel() * getattr(self, f.name).element_size()
                   for f in fields(self))


@dataclass(frozen=True)
class AffineAutoConsts:
    """Per-g 0/1 selector matrices, float64 on the device."""

    row: torch.Tensor       # [n1, n1]  out row j1 <- in row (R[j1, :] hot)
    lam: torch.Tensor       # [n2, n2]  lane stride-g (in @ lam)
    hot_a: torch.Tensor     # [n2, n1]  onehot_a[s, j1] = [s == a(r1(j1))]


def build_tables(prime_list, n: int, n1: int, device) -> AffineAutoTables:
    """The per-limb DFT and twiddle tables over the lane axis (size n2)."""
    n2 = n // n1
    L = len(prime_list)
    r2 = _bitrev(n2)
    r = np.arange(n2, dtype=np.int64)
    fb = np.zeros((L, n2, n2), dtype=np.uint64)
    fib = np.zeros((L, n2, n2), dtype=np.uint64)
    wneg = np.zeros((L, n2, n2), dtype=np.uint64)
    for li, p in enumerate(prime_list):
        psi = primes_mod.primitive_root_2n(p, n)
        w = pow(int(psi), (2 * n) // n2, p)      # a primitive n2-th root
        pw = pow_table(w, n2, p)
        pwi = pow_table(pow(w, -1, p), n2, p)
        fb[li] = pw[np.outer(r, r2) % n2]
        fib[li] = pwi[np.outer(r2, r) % n2] * np.uint64(pow(n2, -1, p)) % np.uint64(p)
        wneg[li] = pwi[np.outer(r, r) % n2]

    def dev(x):
        return torch.from_numpy(x.astype(np.int64)).to(device)

    fb, fib, wneg = dev(fb), dev(fib), dev(wneg)
    fbt = split_halves(fb.transpose(1, 2).contiguous())
    fibt = split_halves(fib.transpose(1, 2).contiguous())
    return AffineAutoTables(
        p=dev(np.asarray(prime_list, dtype=np.uint64)[:, None, None]),
        fb=fb, fib=fib, wneg=wneg, fbt_lo=fbt[0], fbt_hi=fbt[1],
        fibt_lo=fibt[0], fibt_hi=fibt[1], wneg_f=wneg.double())


def build_consts(g: int, n: int, n1: int, device) -> AffineAutoConsts:
    """The per-g selector matrices, bit-reversal conjugated."""
    n2 = n // n1
    g = g % (2 * n)
    assert g % 2 == 1, f"galois element {g} is even"
    c = ((g - 1) // 2) % n
    r1 = _bitrev(n1)
    r2 = _bitrev(n2)
    r1_inv = np.argsort(r1)
    r2_inv = np.argsort(r2)
    src_lo = (g * r1 + c) % n1               # row j1 holds k_lo = r1(j1)
    t = (((g * r1 + c) - src_lo) // n1) % n2
    g_inv = pow(g % n2, -1, n2) if n2 > 1 else 0
    a = (g_inv * t) % n2

    # row one-hot: out[j1, :] = in[r1^{-1}(src_lo(j1)), :]
    row = np.zeros((n1, n1))
    row[np.arange(n1), r1_inv[src_lo]] = 1
    # lane stride-g one-hot (pull): B[..., j2] = A[..., lam(j2)] with
    # lam(j2) = r2^{-1}((g r2(j2)) mod n2), so B = A @ Lam, Lam[lam(j2), j2] = 1
    lam = np.zeros((n2, n2))
    lam[r2_inv[(g * r2) % n2], np.arange(n2)] = 1
    # roll selector: onehot_a[s, j1] = [s == a(j1)]
    hot = np.zeros((n2, n1))
    hot[a, np.arange(n1)] = 1

    def dev(x):
        return torch.from_numpy(x).to(device)

    return AffineAutoConsts(row=dev(row), lam=dev(lam), hot_a=dev(hot))


def _twiddle(consts: AffineAutoConsts, t: AffineAutoTables) -> torch.Tensor:
    """T[L, n1, n2] = (W @ onehot_a)^T per limb: one W entry per output."""
    return torch.matmul(t.wneg_f, consts.hot_a).long().transpose(1, 2)


def apply_affine(x: torch.Tensor, consts: AffineAutoConsts,
                 t: AffineAutoTables) -> torch.Tensor:
    """x [..., L, n] int64 residues in bit-reversed evaluation order ->
    sigma_g(x), bit-identical to x[..., perm] for perm = ctx.galois_perm(g);
    `t` holds the tables of x's L limbs."""
    *lead, L, n = x.shape
    n2 = t.fb.shape[-1]
    n1 = n // n2
    B = int(np.prod(lead)) if lead else 1
    # limb-major [L, B, n1, n2], so that each limb's DFT is one product of a
    # batched [B n1, n2] @ [n2, n2]
    y = x.reshape(B, L, n1, n2).transpose(0, 1).to(torch.float64,
                                                   memory_format=torch.contiguous_format)
    y = torch.matmul(torch.matmul(consts.row, y), consts.lam).long()
    p = t.p
    freq = mod_matmul_halves(y.reshape(L, B * n1, n2), (t.fbt_lo, t.fbt_hi), p)
    freq = mulmod(freq.reshape(L, B, n1, n2), _twiddle(consts, t)[:, None], p[:, None])
    out = mod_matmul_halves(freq.reshape(L, B * n1, n2), (t.fibt_lo, t.fibt_hi), p)
    return out.reshape(L, B, n).transpose(0, 1).reshape(*lead, L, n)
