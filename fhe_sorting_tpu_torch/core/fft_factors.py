"""Sparse factorization of the CKKS canonical-embedding transform.

The port's own copy of `fhe_sorting_tpu/core/fft_factors.py` (pure numpy,
the arithmetic kept verbatim: the diagonals must be bit-equal to the
reference's float64/complex128, or nothing downstream is bit-exact).

The level-budget ("FFT-factored") CoeffsToSlots / SlotsToCoeffs of CKKS
bootstrapping (OpenFHE's levelBudget {4,4}/{5,5}; Chen-Chillotti-Song,
Han-Ki) needs the slot transform split into a product of sparse factors.
This module derives them for our encoding convention (core/encoding.py:
slot t <-> root zeta^{5^t}, zeta = exp(i*pi/n)).

Math.  Pack the two real coefficient halves as one complex vector
c~ = c_lo + i*c_hi (exact because zeta^{e_t*nh} = i for every slot root:
e_t = 5^t = 1 mod 4).  Then slots z = E c~ with the nh x nh matrix

    E[t, k] = zeta^{e_t * k},   e_t = 5^t mod 2n,  nh = n/2.

E is sqrt(nh)-unitary: rows t != t' satisfy sum_k zeta^{(e_t - e_t')k} = 0
because e_t - e_t' = 0 mod 4 while ord(zeta) = 2n, so

    E^{-1} = conj(E)^T / nh.

Decimation on t (the 5^t orbit) factors E into log2(nh) butterfly stages.
With bit-reversed intermediate ordering the stages become stride-2^s
3-generalized-diagonal matrices S~_s, with no explicit permutation left:

    E * P                = S~_{L-1} ... S~_0          (S2C: bitrev in, natural out)
    P * conj(E)^T        = conj(S~_0^T) ... conj(S~_{L-1}^T)   (C2S)

(P = bitrev permutation, an involution.)  A level budget b groups the L
stages into b products; each group has <= 2^(ceil(L/b)) + small diagonals
and costs one multiplicative level through the BSGS LinearTransform.

Stage construction: at depth s the slot index space splits into 2^s blocks
of size M = nh/2^s; block b has root exponent E_b = 5^{bitrev_s(b)} and its
butterfly twiddles are tau_a = zeta^{E_b * g^a * M/2}, g = 5^(2^s) mod 2n.
The bitrev-conjugated stage couples indices differing in bit s.
"""

from __future__ import annotations

import functools

import numpy as np


def _bitrev(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def _zeta_pow(n: int):
    """e -> zeta^e as vectorized table over exponents mod 2n."""
    tab = np.exp(1j * np.pi * np.arange(2 * n) / n)
    return tab


@functools.lru_cache(maxsize=16)
def stage_matrices_dit(n: int):
    """Dense DIT stages S_s with P E = S_{L-1} ... S_0 (validation only)."""
    nh = n // 2
    L = nh.bit_length() - 1
    zp = _zeta_pow(n)
    stages = []
    for s in range(L):
        M = nh >> s
        S = np.zeros((nh, nh), dtype=np.complex128)
        g = pow(5, 1 << s, 2 * n)
        for b in range(1 << s):
            Eb = pow(5, _bitrev(b, s), 2 * n) if s else 1
            t0 = zp[(Eb * (M // 2)) % (2 * n)]
            t1 = zp[(Eb * g * (M // 2)) % (2 * n)]
            base = b * M
            for r in range(M // 2):
                i = base + r
                S[i, i] = 1.0
                S[i, i + M // 2] = t0
                j = base + M // 2 + r
                S[j, j - M // 2] = 1.0
                S[j, j] = t1
        stages.append(S)
    return stages


@functools.lru_cache(maxsize=16)
def stage_diagonals(n: int):
    """Bitrev-conjugated stages S~_s as generalized-diagonal dicts.

    Returns a list (s = 0..L-1) of {offset: complex vector[nh]} with
    S~_{L-1} ... S~_0 = E P.  Offsets of stage s are {0, 2^s, nh - 2^s}.
    """
    nh = n // 2
    L = nh.bit_length() - 1
    zp = _zeta_pow(n)
    out = []
    for s in range(L):
        M = nh >> s
        g = pow(5, 1 << s, 2 * n)
        d0 = np.zeros(nh, dtype=np.complex128)
        dp = np.zeros(nh, dtype=np.complex128)   # offset +2^s
        dm = np.zeros(nh, dtype=np.complex128)   # offset nh - 2^s
        for b in range(1 << s):
            Eb = pow(5, _bitrev(b, s), 2 * n) if s else 1
            t0 = zp[(Eb * (M // 2)) % (2 * n)]
            t1 = zp[(Eb * g * (M // 2)) % (2 * n)]
            base = b * M
            for r in range(M // 2):
                i = base + r                 # top row of the DIT butterfly
                j = base + M // 2 + r        # bottom row
                I = _bitrev(i, L)            # S~ row indices
                J = _bitrev(j, L)            # J = I + 2^s by construction
                d0[I] = 1.0
                dp[I] = t0                   # S~[I, I + 2^s]
                d0[J] = t1
                dm[J] = 1.0                  # S~[J, J - 2^s]
        if (1 << s) == nh - (1 << s):
            # last stage: +-nh/2 coincide as one generalized diagonal
            # (disjoint supports: dp lives on bit_s=0 rows, dm on bit_s=1)
            out.append({0: d0, 1 << s: dp + dm})
        else:
            out.append({0: d0, 1 << s: dp, nh - (1 << s): dm})
    return out


def diag_mul(A: dict, B: dict, nh: int) -> dict:
    """Generalized-diagonal product C = A @ B.

    diag_C(d1+d2)[i] += diag_A(d1)[i] * diag_B(d2)[(i+d1) % nh]."""
    C: dict = {}
    for d1, a in A.items():
        for d2, b in B.items():
            d = (d1 + d2) % nh
            v = a * np.roll(b, -d1)
            if d in C:
                C[d] = C[d] + v
            else:
                C[d] = v.copy()
    return {d: v for d, v in C.items() if np.any(np.abs(v) > 1e-14)}


def diag_transpose_conj(A: dict, nh: int) -> dict:
    """conj(A)^T in generalized-diagonal form:
    diag(d)[i] = conj(A[(i+d)%nh -> row, i -> col]) = conj(diag_A(nh-d)[(i+d)%nh])."""
    # diag_{A^T}(e)[i] = A[(i+e), i] = diag_A((nh-e)%nh)[(i+e)%nh]
    out = {}
    for d, v in A.items():
        e = (nh - d) % nh
        out[e] = np.conj(np.roll(v, -e))
    return out


def _group(stages: list, budget: int, nh: int) -> list:
    """Split L stages into `budget` contiguous groups (balanced), multiply
    each group into one diagonal dict.  Returned in application order
    (index 0 applied first)."""
    L = len(stages)
    budget = max(1, min(budget, L))
    sizes = [L // budget + (1 if i < L % budget else 0) for i in range(budget)]
    groups = []
    idx = 0
    for sz in sizes:
        # product S~_{idx+sz-1} ... S~_{idx} (later stages multiply on the left)
        acc = stages[idx]
        for k in range(idx + 1, idx + sz):
            acc = diag_mul(stages[k], acc, nh)
        groups.append(acc)
        idx += sz
    return groups


def s2c_factors(n: int, budget: int) -> list:
    """SlotsToCoeffs: z_natural = (prod groups, last applied last) c~_bitrev.
    Application order: result[0] first."""
    nh = n // 2
    return _group(stage_diagonals(n), budget, nh)


def c2s_factors(n: int, budget: int) -> list:
    """CoeffsToSlots: c~_bitrev = (1/nh) * (prod groups) z_natural,
    where the 1/nh is folded into the FIRST applied group.
    P conj(E)^T = conj(S~_0^T) ... conj(S~_{L-1}^T): the transposed-conj
    stages apply in reverse stage order, so group, then transpose each."""
    nh = n // 2
    stages = stage_diagonals(n)
    rev = [diag_transpose_conj(S, nh) for S in reversed(stages)]
    # rev[0] = conj(S~_{L-1}^T) is applied FIRST (rightmost factor)
    groups = _group(rev, budget, nh)
    groups[0] = {d: v / nh for d, v in groups[0].items()}
    return groups


def dense_from_diags(diags: dict, nh: int) -> np.ndarray:
    M = np.zeros((nh, nh), dtype=np.complex128)
    for d, v in diags.items():
        for i in range(nh):
            M[i, (i + d) % nh] = v[i]
    return M


def embedding_matrix(n: int) -> np.ndarray:
    """E[t, k] = zeta^(5^t k) (dense; tests/small rings only)."""
    nh = n // 2
    zp = _zeta_pow(n)
    e = np.empty(nh, dtype=np.int64)
    acc = 1
    for t in range(nh):
        e[t] = acc
        acc = acc * 5 % (2 * n)
    k = np.arange(nh)
    return zp[(e[:, None] * k[None, :]) % (2 * n)]
