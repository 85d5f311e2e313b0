"""Negacyclic NTT over int64 limb planes: the butterfly path and host NTTs.

Port of `fhe_sorting_tpu/core/ntt.py`.  The forward transform maps
coefficient order to bit-reversed evaluation order (Cooley-Tukey with
merged twiddles), the inverse maps back (Gentleman-Sande, then 1/n).  Both
run in the constant-geometry form: every stage pairs (i, i + n/2) with
(2i, 2i+1), so one loop body covers all log2(n) stages.

This butterfly is plain PyTorch.  A context uses it for rings too small for
the four-step kernel (`core/ntt_mxu.py`, `core/fs_ntt.py`) and on the CPU.

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


@dataclass(frozen=True)
class NttTables:
    """Butterfly twiddles for a set of primes, int64 on the context device.

    Stage s of the forward transform multiplies lane i by
    psi_rev[2^s + (i mod 2^s)]; `cg_psi[s]` holds that vector.  The inverse
    stages run s = logn-1 .. 0 and `cg_ipsi` is stored in that order.
    """

    p: torch.Tensor          # [L, 1]
    n_inv: torch.Tensor      # [L, 1]
    cg_psi: torch.Tensor     # [logn, L, n/2]
    cg_ipsi: torch.Tensor    # [logn, L, n/2]


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


def _cg_stack(tab: np.ndarray, n: int) -> np.ndarray:
    """[L, n] twiddle table -> [logn, L, n/2] constant-geometry stages."""
    logn = n.bit_length() - 1
    L = tab.shape[0]
    out = np.zeros((logn, L, n // 2), dtype=tab.dtype)
    for s in range(logn):
        m = 1 << s
        out[s] = np.tile(tab[:, m : 2 * m], (1, (n // 2) // m))
    return out


def build_device_tables(prime_list, n: int, device="cpu") -> NttTables:
    psi_rev, ipsi_rev, n_inv = build_host_tables(prime_list, n)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x).astype(np.int64)).to(device)

    return NttTables(
        p=dev(np.asarray(prime_list, dtype=np.int64)[:, None]),
        n_inv=dev(n_inv[:, None]),
        cg_psi=dev(_cg_stack(psi_rev, n)),
        cg_ipsi=dev(_cg_stack(ipsi_rev, n)[::-1]),
    )


def ntt(a: torch.Tensor, t, limbs=None) -> torch.Tensor:
    """Forward negacyclic NTT.  a: [..., L, n] coeff order -> bitrev eval.

    Dispatches on the table type: `FourStepTables` runs the four-step path
    (`core/ntt_mxu.py`), `NttTables` the butterfly below."""
    if not isinstance(t, NttTables):
        from .ntt_mxu import ntt_fs

        return ntt_fs(a, t, limbs)
    *lead, L, n = a.shape
    h = n // 2
    p, cg = (t.p, t.cg_psi) if limbs is None else (t.p[limbs], t.cg_psi[:, limbs])
    x = a
    for s in range(n.bit_length() - 1):
        u = x[..., :h]
        v = mulmod(x[..., h:], cg[s], p)
        x = torch.stack([add_mod(u, v, p), sub_mod(u, v, p)], dim=-1).reshape(*lead, L, n)
    return x


def intt(a: torch.Tensor, t, limbs=None) -> torch.Tensor:
    """Inverse NTT.  a: [..., L, n] bitrev eval order -> coeff order."""
    if not isinstance(t, NttTables):
        from .ntt_mxu import intt_fs

        return intt_fs(a, t, limbs)
    *lead, L, n = a.shape
    h = n // 2
    if limbs is None:
        p, cg, ninv = t.p, t.cg_ipsi, t.n_inv
    else:
        p, cg, ninv = t.p[limbs], t.cg_ipsi[:, limbs], t.n_inv[limbs]
    x = a
    for s in range(n.bit_length() - 1):
        z = x.reshape(*lead, L, h, 2)
        u, v = z[..., 0], z[..., 1]
        x = torch.cat([add_mod(u, v, p), mulmod(sub_mod(u, v, p), cg[s], p)], dim=-1)
    return mulmod(x, ninv, p)


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
