"""Negacyclic NTT over int64 limb planes: the butterfly path and host NTTs.

Port of `fhe_sorting_tpu/core/ntt.py`.  The forward transform maps
coefficient order to bit-reversed evaluation order (Cooley-Tukey with
merged twiddles), the inverse maps back (Gentleman-Sande, then 1/n).

`ntt`/`intt` dispatch on the table type: `FourStepTables` run the four-step
path (`core/ntt_mxu.py`, kernel K1), `NttTables` the butterfly.  A butterfly
on a CUDA tensor launches the hand-written kernel K2 (`core/bf_ntt.py`) or
raises; on a CPU tensor it runs `butterfly_plain` below, K2's plain PyTorch
version, in the constant-geometry form: every stage pairs (i, i + n/2) with
(2i, 2i+1), so one loop body covers all log2(n) stages, and lane i of stage
s takes the twiddle psi_rev[2^s + (i mod 2^s)].

Data layout: [..., L, n] int64, one prime per limb plane.  Every transform
takes `limbs`, an int64 index tensor into the context's full tables (None
means all), so callers never build sliced table copies themselves.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import primes as primes_mod
from .modmath import add_mod, mulmod, sub_mod


def bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def pow_table(base: int, count: int, p: int) -> np.ndarray:
    """[1, b, b^2, ..., b^{count-1}] mod p, vectorized doubling build."""
    t = np.array([1], dtype=np.uint64)
    cur = base % p
    while len(t) < count:
        t = np.concatenate([t, t * np.uint64(cur) % np.uint64(p)])
        cur = cur * cur % p
    return t[:count]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: `None` means the first CUDA card,
    and raises where there is none; the CPU has to be asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device=\"cpu\" to run on the CPU")
        return torch.device("cuda:0")
    return torch.device(device)


@dataclass(frozen=True)
class NttTables:
    """Butterfly twiddles for a set of primes, int64 on the context device.

    `psi_rev[l, 2^s + g]` is the twiddle of group g in forward stage s (the
    powers of psi in bit-reversed order), `ipsi_rev` the same for the
    inverse; the plain version reads these.  The kernel K2 reads
    `psi_pack`/`ipsi_pack`, the same twiddles with their Shoup quotients,
    w | floor(w 2^32 / p) << 32: two u32 in the 8 bytes of the int64.
    """

    p: torch.Tensor          # [L, 1]
    n_inv: torch.Tensor      # [L, 1]
    psi_rev: torch.Tensor    # [L, n]
    ipsi_rev: torch.Tensor   # [L, n]
    psi_pack: torch.Tensor   # [L, n]
    ipsi_pack: torch.Tensor  # [L, n]
    lazy: bool = False       # every prime below 2^30: K2 may delay its reductions


def build_host_tables(prime_list, n: int):
    """Numpy twiddle tables (psi_rev, ipsi_rev, n_inv), u64."""
    rev = bit_reverse_indices(n)
    L = len(prime_list)
    psi_rev = np.zeros((L, n), dtype=np.uint64)
    ipsi_rev = np.zeros((L, n), dtype=np.uint64)
    n_inv = np.zeros((L,), dtype=np.uint64)
    for li, p in enumerate(prime_list):
        psi = primes_mod.primitive_root_2n(p, n)
        psi_rev[li] = pow_table(psi, n, p)[rev]
        ipsi_rev[li] = pow_table(pow(psi, -1, p), n, p)[rev]
        n_inv[li] = pow(n, -1, p)
    return psi_rev, ipsi_rev, n_inv


def build_device_tables(prime_list, n: int, device=None, host=None) -> NttTables:
    """Butterfly tables on `device` (None: the first CUDA card).  `host` takes
    the result of `build_host_tables` where the caller has it already."""
    device = resolve_device(device)
    psi_rev, ipsi_rev, n_inv = host or build_host_tables(prime_list, n)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x).astype(np.int64)).to(device)

    primes_col = np.asarray(prime_list, dtype=np.uint64)[:, None]

    def pack(w):
        # the bit pattern of (w, floor(w 2^32 / p)) as one int64
        return dev((w | ((w << np.uint64(32)) // primes_col) << np.uint64(32)).view(np.int64))

    return NttTables(
        p=dev(primes_col),
        n_inv=dev(n_inv[:, None]),
        psi_rev=dev(psi_rev),
        ipsi_rev=dev(ipsi_rev),
        psi_pack=pack(psi_rev),
        ipsi_pack=pack(ipsi_rev),
        lazy=max(prime_list) < 2**30,
    )


def butterfly_plain(a: torch.Tensor, t: NttTables, limbs, inverse: bool) -> torch.Tensor:
    """The butterfly NTT (or its inverse) in plain PyTorch, a: [..., L, n]."""
    *lead, L, n = a.shape
    h = n // 2
    logn = n.bit_length() - 1
    tab = t.ipsi_rev if inverse else t.psi_rev
    p, ninv = t.p, t.n_inv
    if limbs is not None:
        p, ninv, tab = p[limbs], ninv[limbs], tab[limbs]

    def twiddle(y, s):
        # lane i of y [..., L, n/2] times tab[2^s + (i mod 2^s)]
        m = 1 << s
        y = y.reshape(*lead, L, h // m, m)
        return mulmod(y, tab[:, None, m : 2 * m], p[:, None]).reshape(*lead, L, h)

    x = a
    if not inverse:
        for s in range(logn):
            u = x[..., :h]
            v = twiddle(x[..., h:], s)
            x = torch.stack([add_mod(u, v, p), sub_mod(u, v, p)], dim=-1).reshape(*lead, L, n)
        return x
    for s in reversed(range(logn)):
        z = x.reshape(*lead, L, h, 2)
        u, v = z[..., 0], z[..., 1]
        x = torch.cat([add_mod(u, v, p), twiddle(sub_mod(u, v, p), s)], dim=-1)
    return mulmod(x, ninv, p)


def _transform(a: torch.Tensor, t, limbs, inverse: bool) -> torch.Tensor:
    if isinstance(t, NttTables):
        from . import bf_ntt

        *lead, L, n = a.shape
        x = a.reshape(-1, L, n).contiguous()
        return bf_ntt.butterfly(x, t, limbs, inverse).reshape(*lead, L, n)
    from .ntt_mxu import intt_fs, ntt_fs

    return (intt_fs if inverse else ntt_fs)(a, t, limbs)


def ntt(a: torch.Tensor, t, limbs=None) -> torch.Tensor:
    """Forward negacyclic NTT.  a: [..., L, n] coeff order -> bitrev eval."""
    return _transform(a, t, limbs, inverse=False)


def intt(a: torch.Tensor, t, limbs=None) -> torch.Tensor:
    """Inverse NTT.  a: [..., L, n] bitrev eval order -> coeff order."""
    return _transform(a, t, limbs, inverse=True)


# ---------------------------------------------------------------------------
# Host-side (numpy uint64) transforms for key generation, encrypt, decrypt.
# ---------------------------------------------------------------------------


def host_ntt(a: np.ndarray, psi_rev_l: np.ndarray, p: int) -> np.ndarray:
    """Forward NTT of one limb on the host.  a: [n] u64, canonical residues."""
    from . import native

    if native.available():
        return native.ntt_batch(a[None], psi_rev_l, int(p))[0]
    n = a.shape[0]
    x = a.astype(np.uint64).copy()
    P = np.uint64(p)
    for s in range(n.bit_length() - 1):
        m = 1 << s
        x = x.reshape(m, 2, n >> (s + 1))
        S = psi_rev_l[m : 2 * m].astype(np.uint64)[:, None]
        u = x[:, 0, :]
        v = x[:, 1, :] * S % P
        x = np.stack([(u + v) % P, (u + P - v) % P], axis=1)
    return x.reshape(n)


def host_intt(a: np.ndarray, ipsi_rev_l: np.ndarray, n_inv_l: int, p: int) -> np.ndarray:
    from . import native

    if native.available():
        return native.intt_batch(a[None], ipsi_rev_l, int(n_inv_l), int(p))[0]
    n = a.shape[0]
    x = a.astype(np.uint64).copy()
    P = np.uint64(p)
    for s in range(n.bit_length() - 2, -1, -1):
        m = 1 << s
        x = x.reshape(m, 2, n >> (s + 1))
        S = ipsi_rev_l[m : 2 * m].astype(np.uint64)[:, None]
        u = x[:, 0, :]
        v = x[:, 1, :]
        x = np.stack([(u + v) % P, (u + P - v) % P * S % P], axis=1)
    return x.reshape(n) * np.uint64(n_inv_l) % P
