"""CKKS canonical-embedding encode/decode (host side, exact).

The port's own copy of `fhe_sorting_tpu/core/encoding.py` (numpy only).
Encode/decode are client-side operations (the serving path never decrypts),
so they run on the host in float64 / Python-int precision; only the
resulting integer residue planes ever reach the device.

Slot convention: slot t of an n-ring ciphertext corresponds to the primitive
2n-th root zeta^{5^t} (zeta = exp(i*pi/n)); the conjugate root carries the
conjugate value so coefficients are real.  Sparse packing with s < n/2 slots
tiles the slot vector (n/2)//s times, which makes the `slots` metadata the
exact analogue of OpenFHE's SetSlots sparse re-interpretation.

The coefficient<->evaluation maps are computed with a twisted FFT:
p(zeta^{2j+1}) over all j equals FFT_n(a_k * zeta^k).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=8)
def _slot_index_tables(n: int):
    """(j_t, jconj_t) arrays: FFT bin of slot t's root and its conjugate."""
    m = 2 * n
    nh = n // 2
    e = np.empty(nh, dtype=np.int64)
    acc = 1
    for t in range(nh):
        e[t] = acc
        acc = acc * 5 % m
    j = (e - 1) // 2
    jc = (m - e - 1) // 2
    return j, jc


@functools.lru_cache(maxsize=8)
def _twist(n: int):
    zeta = np.exp(1j * np.pi / n)
    k = np.arange(n)
    return zeta**k, zeta ** (-k)


def encode_coeffs(values, n: int, scale: float, slots: int | None = None):
    """Real slot values -> integer coefficient vector (int64, centered).

    values: array of length `slots` (defaults to len(values)); must divide
    n/2.  The slot vector is tiled to full packing.
    """
    values = np.asarray(values)
    values = values.astype(
        np.complex128 if np.iscomplexobj(values) else np.float64
    )
    s = slots if slots is not None else len(values)
    assert len(values) == s and n // 2 % s == 0, (len(values), s, n)
    zz = np.tile(values, (n // 2) // s).astype(np.complex128)

    j, jc = _slot_index_tables(n)
    v = np.zeros(n, dtype=np.complex128)
    v[j] = zz
    v[jc] = np.conj(zz)

    tw, itw = _twist(n)
    a = np.fft.fft(v) / n * itw
    coeffs = np.rint(a.real * scale)
    if np.abs(coeffs).max() >= 2**62:
        # e.g. an index vector encoded at a squared scale (~2^112): keep
        # float64 - coeffs_to_residues reduces it by an exact two-part
        # split (the 2^-53 relative representation error is far below the
        # CKKS noise floor at these scales)
        return coeffs
    return coeffs.astype(np.int64)


def decode_coeffs(coeffs_float, n: int, scale: float, slots: int):
    """Float coefficient vector -> complex slot values (first period)."""
    tw, itw = _twist(n)
    v = np.fft.ifft(np.asarray(coeffs_float, dtype=np.complex128) * tw) * n
    j, _ = _slot_index_tables(n)
    full = v[j] / scale
    return full[:slots]


def embed_inverse(z, n: int) -> np.ndarray:
    """Float canonical-embedding inverse: slot vector (n/2 complex, full
    packing) -> real coefficient vector (n), no scaling/rounding."""
    z = np.asarray(z, dtype=np.complex128)
    assert len(z) == n // 2
    j, jc = _slot_index_tables(n)
    v = np.zeros(n, dtype=np.complex128)
    v[j] = z
    v[jc] = np.conj(z)
    tw, itw = _twist(n)
    return (np.fft.fft(v) / n * itw).real


def embed_forward(a, n: int) -> np.ndarray:
    """Float canonical embedding: real coefficients (n) -> slots (n/2)."""
    tw, itw = _twist(n)
    v = np.fft.ifft(np.asarray(a, dtype=np.complex128) * tw) * n
    j, _ = _slot_index_tables(n)
    return v[j]


def coeffs_to_residues(coeffs: np.ndarray, prime_list) -> np.ndarray:
    """Centered coefficients -> canonical residue planes [L, n] u64.

    int64 input: direct vectorized modulo.  float64 input (|c| up to
    ~2^124, e.g. squared-scale encodes): exact two-part split
    c = hi*2^62 + lo with hi, lo representable in int64, reduced as
    (hi * (2^62 mod p) + lo) mod p - still fully vectorized (the Python-
    bigint fallback costs ~seconds per plaintext at ring 2^17).
    """
    out = np.zeros((len(prime_list), len(coeffs)), dtype=np.uint64)
    if coeffs.dtype == np.float64:
        if np.abs(coeffs).max() >= 2.0**124:
            coeffs = np.array([int(c) for c in coeffs], dtype=object)
        else:
            hi = np.floor(coeffs / 2.0**62)
            lo = coeffs - hi * 2.0**62          # in [0, 2^62), exact in f64
            hi64 = hi.astype(np.int64)
            lo64 = lo.astype(np.int64)
            for i, p in enumerate(prime_list):
                p64 = np.int64(p)
                w = np.int64(pow(2, 62, int(p)))
                out[i] = (((hi64 % p64) * w + lo64) % p64).astype(np.uint64)
            return out
    if coeffs.dtype != object:
        # vectorized int64 path (the exact-bigint fallback below costs
        # ~Python-int ops per (coeff, limb) - 100x slower at ring 2^17)
        c64 = coeffs.astype(np.int64)
        for i, p in enumerate(prime_list):
            out[i] = (c64 % np.int64(p)).astype(np.uint64)
        return out
    c = coeffs.astype(object)
    for i, p in enumerate(prime_list):
        out[i] = np.asarray(c % p, dtype=np.uint64)
    return out


# ---------------------------------------------------------------------------
# CRT -> centered float (Garner mixed-radix; safe for small centered values)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _garner_tables(prime_tuple):
    L = len(prime_tuple)
    # minv[i] = (prod_{k<i} q_k)^{-1} mod q_i ; pm[i][j] = prod_{k<j} q_k mod q_i
    minv = np.zeros(L, dtype=np.uint64)
    pm = np.zeros((L, L), dtype=np.uint64)
    for i, qi in enumerate(prime_tuple):
        prod = 1
        for j in range(L):
            pm[i, j] = prod % qi
            prod *= prime_tuple[j]
        prodi = 1
        for k in range(i):
            prodi = prodi * prime_tuple[k] % qi
        minv[i] = pow(int(prodi), -1, qi) if i > 0 else 1
    # weights W[j] = prod_{k<j} q_k as float64 (may overflow for j large; only
    # used where digits are nonzero, i.e. small centered values)
    W = np.zeros(L, dtype=np.float64)
    prod = 1
    for j in range(L):
        W[j] = float(prod) if prod < 2**1020 else np.inf
        prod *= prime_tuple[j]
    return minv, pm, W


def _garner_digits(res: np.ndarray, prime_tuple) -> np.ndarray:
    """Mixed-radix digits v[i] (0 <= v_i < q_i) of the CRT value."""
    L, n = res.shape
    minv, pm, _ = _garner_tables(prime_tuple)
    from . import native

    if native.available():
        return native.garner(res, prime_tuple, minv, pm)
    v = np.zeros((L, n), dtype=np.uint64)
    for i in range(L):
        qi = np.uint64(prime_tuple[i])
        t = res[i] % qi
        acc = np.zeros(n, dtype=np.uint64)
        for j in range(i):
            acc = (acc + v[j] * pm[i, j]) % qi
        t = (t + qi - acc % qi) % qi
        v[i] = t * minv[i] % qi if i > 0 else t
    return v


def crt_to_float_centered(res: np.ndarray, prime_list) -> np.ndarray:
    """Residue planes [L, n] -> centered values as float64 [n].

    Assumes |value| << Q (true for decrypted CKKS messages); raises if the
    value uses more than ~2^200 of headroom in both signs (noise blowup).
    """
    pt = tuple(int(p) for p in prime_list)
    L, n = res.shape
    _, _, W = _garner_tables(pt)
    vpos = _garner_digits(res, pt)
    neg = np.zeros_like(res)
    for i, p in enumerate(pt):
        r = res[i]
        neg[i] = np.where(r == 0, r, np.uint64(p) - r)
    vneg = _garner_digits(neg, pt)

    hi = max(1, min(L - 1, 8))
    pos_ok = (vpos[hi:].sum(axis=0) == 0) if L > hi else np.ones(n, bool)
    neg_ok = (vneg[hi:].sum(axis=0) == 0) if L > hi else np.ones(n, bool)
    if not np.all(pos_ok | neg_ok):
        raise OverflowError("decrypted value too large: noise blowup?")

    def fold(v):
        out = np.zeros(n, dtype=np.float64)
        for j in range(min(L, hi)):
            out += v[j].astype(np.float64) * W[j]
        return out

    return np.where(pos_ok, fold(vpos), -fold(vneg))
