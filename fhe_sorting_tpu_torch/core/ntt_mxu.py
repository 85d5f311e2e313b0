"""Four-step negacyclic NTT (matmul formulation) and exact modular matmul.

Port of `fhe_sorting_tpu/core/ntt_mxu.py`.  With n = n1 * n2 the transform
is two modular matrix products against constant tables with a pointwise
twiddle between them:

    forward   Y = ((W1 @ X) * T) @ W2        X = reshape(x, [n1, n2])
    inverse   Y = W1i @ ((X @ W2i) * Ti)

The psi twists, 1/n and the bit-reversed output order of `core/ntt.py` are
folded into the tables, so the result is bit-identical to the butterfly.

Tables are held as int64 residues.  `ntt_fs`/`intt_fs` send CUDA tensors to
the hand-written kernel (`core/fs_ntt.py`); on the CPU they run
`ntt_plain`, the plain PyTorch version below.  The kernel multiplies on the
s8 tensor cores, so tables built on a CUDA device carry a second copy in the
kernel's form (`FourStepKernelTables`): the constant matrices as four
balanced s8 digit planes, cut into the stages the kernel copies, and the
twiddles packed with their Shoup quotients.  It is made once, at table build.

`mod_matmul` is the exact modular product used by the plain four-step, by
the key-switch base extensions (ModUp, ModDown) and by `Evaluator.combo`.
PyTorch has no integer matmul on CUDA, so it multiplies 16-bit halves in
float64, where every partial sum is an exact integer.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from . import primes as primes_mod
from .modmath import host_shoup, mulmod
from .ntt import bit_reverse_indices, pow_table, resolve_device


def split_n(n: int) -> tuple[int, int]:
    logn = n.bit_length() - 1
    n1 = 1 << (logn // 2)
    return n1, n // n1


def supported(n: int, n1: int) -> bool:
    """Rings whose four-step split tiles like the reference's fused kernel
    (n1, n2 multiples of 128, i.e. ring >= 2^15)."""
    return n1 % 128 == 0 and (n // n1) % 128 == 0


DIGITS = 4              # balanced s8 digits of a residue below 2^30
_BIAS = 0x80808080      # 128 in every byte


def digit_planes(v: torch.Tensor) -> torch.Tensor:
    """Residues v [L, R, K] (int64, below 2^30) as four balanced s8 digit
    planes [L, 4, R, K]: v = sum_i d_i 256^i with d_i in [-128, 127].  Adding
    128 to every byte position at once carries exactly as the digit-by-digit
    rule does; byte i of the sum is then d_i + 128."""
    t = v + _BIAS
    return torch.stack([((t >> (8 * i)) & 0xFF) - 128 for i in range(DIGITS)],
                       dim=1).to(torch.int8)


def from_digit_planes(d: torch.Tensor) -> torch.Tensor:
    """Inverse of `digit_planes`: [L, 4, R, K] s8 -> [L, R, K] int64."""
    return sum(d[:, i].long() << (8 * i) for i in range(DIGITS))


# The kernel copies one stage of a table into shared memory in one piece, so
# the digit planes are stored as the stages it reads: for each limb, each tile
# of `tile_rows` rows and each step of STEP of the depth K, the four digit
# planes of that block, every row padded to ROW_BYTES (the padding keeps the
# kernel's shared-memory reads apart).
STEP, ROW_BYTES = 64, 80


def tile_rows(rows: int) -> int:
    """Rows of a table tile: 128, or 64 where the matrix has no 128."""
    return 128 if rows % 128 == 0 else 64


def tiled_digit_planes(v: torch.Tensor) -> torch.Tensor:
    """Square residue matrices v [L, R, K] -> s8 [L, R/T, K/STEP, 4, T, ROW_BYTES]."""
    L, R, K = v.shape
    T = tile_rows(R)
    d = digit_planes(v).reshape(L, DIGITS, R // T, T, K // STEP, STEP).permute(0, 2, 4, 1, 3, 5)
    out = torch.zeros(L, R // T, K // STEP, DIGITS, T, ROW_BYTES, dtype=torch.int8, device=v.device)
    out[..., :STEP] = d
    return out


def from_tiled_digit_planes(t: torch.Tensor) -> torch.Tensor:
    """Inverse of `tiled_digit_planes`: -> [L, R, K] int64."""
    L, nt, nk, _, T, _ = t.shape
    d = t[..., :STEP].permute(0, 3, 1, 4, 2, 5).reshape(L, DIGITS, nt * T, nk * STEP)
    return from_digit_planes(d)


@dataclass(frozen=True)
class FourStepKernelTables:
    """The kernel's copy of the tables.  A matrix is stored with the
    product's depth K as its contiguous axis, `w1f`/`w1i` (left operands,
    [n1, K=n1]) as they are, `w2f`/`w2i` (right operands, [K=n2, n2])
    transposed, and then as tiled digit planes (`tiled_digit_planes`).
    `tf`/`ti` hold t | floor(t 2^32 / p) << 32.
    `mods` holds, per prime, what the kernel's reduction of a digit sum needs:
    p | (2^32 mod p) << 32, that residue's Shoup quotient | floor(2^52 / p)
    << 32, and the multiples of p just above 2^50 and above 2^42."""

    w1f: torch.Tensor      # [L, n1/T, n1/64, 4, T, 80] int8
    w2f: torch.Tensor      # [L, n2/T, n2/64, 4, T, 80] int8, digits of w2f^T
    w2i: torch.Tensor      # the same of w2i^T
    w1i: torch.Tensor      # as w1f
    tf: torch.Tensor       # [L, n1, n2] int64, two packed u32
    ti: torch.Tensor       # [L, n1, n2] int64
    mods: torch.Tensor     # [L, 4] int64

    def nbytes(self) -> int:
        return sum(getattr(self, f.name).numel() * getattr(self, f.name).element_size()
                   for f in fields(self))


@dataclass(frozen=True)
class FourStepTables:
    """Per-limb constant tables, int64 residues (and u32 Shoup quotients)
    on the context device; `kern` is the kernel's copy (CUDA devices only)."""

    p: torch.Tensor        # [L, 1, 1]
    w1f: torch.Tensor      # [L, n1, n1]  rows bitrev, psi^(n2 i1) folded
    tf: torch.Tensor       # [L, n1, n2]  omega^(rev(j1) i2) psi^(i2)
    tf_sh: torch.Tensor    # [L, n1, n2]  floor(tf * 2^32 / p)
    w2f: torch.Tensor      # [L, n2, n2]  cols bitrev
    w2i: torch.Tensor      # [L, n2, n2]
    ti: torch.Tensor       # [L, n1, n2]  incl. psi^(-i2) / n
    ti_sh: torch.Tensor    # [L, n1, n2]
    w1i: torch.Tensor      # [L, n1, n1]  psi^(-n2 i1) folded
    kern: FourStepKernelTables | None = None

    @property
    def n1(self) -> int:
        return self.w1f.shape[-1]

    def select(self, limbs) -> "FourStepTables":
        """Tables of a subset of limbs (a gathered copy)."""
        if limbs is None:
            return self
        return FourStepTables(*(getattr(self, name)[limbs] for name in INT64_TABLES))


INT64_TABLES = tuple(f.name for f in fields(FourStepTables) if f.name != "kern")


def build_kernel_tables(t: FourStepTables) -> FourStepKernelTables:
    """The kernel's form of the int64 tables `t`, on the same device."""
    mods = []
    for p in t.p.flatten().tolist():
        r32 = (1 << 32) % p
        mods.append([p | r32 << 32, (r32 << 32) // p | ((1 << 52) // p) << 32,
                     ((1 << 50) // p + 1) * p, ((1 << 42) // p + 1) * p])
    return FourStepKernelTables(
        mods=torch.tensor(mods, dtype=torch.int64, device=t.p.device),
        w1f=tiled_digit_planes(t.w1f),
        w2f=tiled_digit_planes(t.w2f.transpose(1, 2)),
        w2i=tiled_digit_planes(t.w2i.transpose(1, 2)),
        w1i=tiled_digit_planes(t.w1i),
        tf=t.tf | (t.tf_sh << 32),
        ti=t.ti | (t.ti_sh << 32))


def build_fs_tables(prime_list, n: int, device=None) -> FourStepTables:
    """Four-step tables on `device` (None: the first CUDA card)."""
    device = resolve_device(device)
    n1, n2 = split_n(n)
    # The reference's digit-matmul recombination needs 4*128^2*max(n1,n2) < p,
    # and p < 2^30 keeps its balanced digits in int32.  The port keeps the
    # same range so both packages accept the same chains; the CUDA kernel
    # relies on it too (four s8 digits, and the widths of its recombination).
    bound = 4 * 128 * 128 * max(n1, n2)
    for p in prime_list:
        assert bound < p < 2**30, (
            f"prime {p} outside four-step NTT range (need {bound} < p < 2^30);"
            " use the butterfly path"
        )
    r1, r2 = bit_reverse_indices(n1), bit_reverse_indices(n2)
    i1 = np.arange(n1, dtype=np.int64)
    i2 = np.arange(n2, dtype=np.int64)
    L = len(prime_list)
    out = {f: np.zeros((L,) + s, dtype=np.uint64) for f, s in (
        ("w1f", (n1, n1)), ("tf", (n1, n2)), ("tf_sh", (n1, n2)),
        ("w2f", (n2, n2)), ("w2i", (n2, n2)), ("ti", (n1, n2)),
        ("ti_sh", (n1, n2)), ("w1i", (n1, n1)))}

    for li, p in enumerate(prime_list):
        psi = primes_mod.primitive_root_2n(p, n)
        pw = pow_table(psi * psi % p, n, p)   # omega^e, e in [0, n)
        ps = pow_table(psi, 2 * n, p)         # psi^e,   e in [0, 2n)
        ninv = pow(n, -1, p)
        out["w1f"][li] = (pw[(n2 * np.outer(r1, i1)) % n]
                          * ps[(n2 * i1[None, :]) % (2 * n)]) % p
        out["tf"][li] = (pw[np.outer(r1, i2) % n] * ps[i2[None, :] % (2 * n)]) % p
        out["w2f"][li] = pw[(n1 * np.outer(i2, r2)) % n]
        out["w2i"][li] = pw[np.mod(-n1 * np.outer(r2, i2), n)]
        out["ti"][li] = ((pw[np.mod(-np.outer(r1, i2), n)]
                          * ps[np.mod(-i2[None, :], 2 * n)]) % p
                         * np.uint64(ninv) % p)
        out["w1i"][li] = (pw[np.mod(-n2 * np.outer(i1, r1), n)]
                          * ps[np.mod(-n2 * i1[:, None], 2 * n)]) % p
        out["tf_sh"][li] = host_shoup(out["tf"][li], p)
        out["ti_sh"][li] = host_shoup(out["ti"][li], p)

    def dev(x):
        return torch.from_numpy(x.astype(np.int64)).to(device)

    t = FourStepTables(
        p=dev(np.asarray(prime_list, dtype=np.uint64)[:, None, None]),
        **{f: dev(v) for f, v in out.items()})
    if device.type == "cuda":
        t = replace(t, kern=build_kernel_tables(t))
    return t


def mod_matmul(a: torch.Tensor, b: torch.Tensor, p) -> torch.Tensor:
    """Exact (a @ b) mod p for int64 residues below 2^31.

    a [..., M, K], b [..., K, N] (batch dims broadcast as in torch.matmul);
    p is an int64 tensor broadcastable to [..., M, N] (one modulus per limb
    or per output row).  Each operand is split into 16-bit halves and the
    four half products run as float64 matmuls: every partial sum is an
    integer below K * 2^32, exact in float64 for K < 2^21.
    """
    return mod_matmul_halves(a, split_halves(b), p)


def split_halves(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 16-bit halves of int64 residues below 2^32, as float64."""
    return (b & 0xFFFF).double(), (b >> 16).double()


def mod_matmul_halves(a: torch.Tensor, b_halves, p) -> torch.Tensor:
    """`mod_matmul` against a right operand split once by `split_halves`."""
    a_lo, a_hi = split_halves(a)
    b_lo, b_hi = b_halves
    ll = torch.matmul(a_lo, b_lo).long()
    mid = (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)).long()
    hh = torch.matmul(a_hi, b_hi).long()
    # (hh mod p) * (2^32 mod p) < 2^62, (mid mod p) * 2^16 < 2^47, ll < 2^53:
    # the sum stays below 2^63
    two32 = torch.remainder(torch.full_like(p, 1 << 32), p)
    return torch.remainder(torch.remainder(hh, p) * two32
                           + torch.remainder(mid, p) * 65536 + ll, p)


def ntt_plain(x: torch.Tensor, t: FourStepTables, limbs, inverse: bool) -> torch.Tensor:
    """Plain PyTorch four-step: x [B, L, n1, n2] int64 -> same shape."""
    t = t.select(limbs)
    p = t.p
    if not inverse:
        u = mod_matmul(t.w1f, x, p)
        return mod_matmul(mulmod(u, t.tf, p), t.w2f, p)
    s = mod_matmul(x, t.w2i, p)
    return mod_matmul(t.w1i, mulmod(s, t.ti, p), p)


def _four_step(a: torch.Tensor, t: FourStepTables, limbs, inverse: bool):
    from . import fs_ntt

    *lead, L, n = a.shape
    n1 = t.n1
    x = a.reshape(-1, L, n1, n // n1).contiguous()
    return fs_ntt.four_step(x, t, limbs, inverse).reshape(*lead, L, n)


def ntt_fs(a: torch.Tensor, t: FourStepTables, limbs=None) -> torch.Tensor:
    """Forward negacyclic NTT, [..., L, n] coeff -> bitrev eval (matches
    `core/ntt.py` `ntt` bit-exactly).  `limbs` indexes the tables."""
    return _four_step(a, t, limbs, inverse=False)


def intt_fs(a: torch.Tensor, t: FourStepTables, limbs=None) -> torch.Tensor:
    """Inverse NTT, [..., L, n] bitrev eval -> coeff order."""
    return _four_step(a, t, limbs, inverse=True)
