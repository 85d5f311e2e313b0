"""NTT-friendly prime generation for the RNS-CKKS modulus chain.

The port's own copy of `fhe_sorting_tpu/core/primes.py` (Python integers
only).  Every prime p satisfies p = 1 (mod 2*ring_n), so that a primitive
2n-th root of unity exists (negacyclic NTT), and p < 2^31, so that a product
of two residues fits in 63 bits.
"""

from __future__ import annotations

import functools

# Deterministic Miller-Rabin for n < 3.317e24 with these witnesses.
_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@functools.lru_cache(maxsize=None)
def ntt_primes(ring_n: int, bit_size: int, count: int, skip: int = 0,
               exclude=()) -> tuple:
    """`count` primes p = 1 (mod 2*ring_n) closest below 2**bit_size.

    `skip` skips the first few candidates so that disjoint prime sets can be
    drawn for scaling vs. special moduli at the same bit size; `exclude`
    rejects specific primes already used elsewhere in the chain.
    """
    assert bit_size <= 31, "residue arithmetic requires primes < 2^31"
    m = 2 * ring_n
    excl = set(exclude)
    out = []
    # Largest candidate of the form k*m + 1 below 2^bit_size.
    k = (2**bit_size - 2) // m
    skipped = 0
    while len(out) < count and k > 0:
        cand = k * m + 1
        k -= 1
        if cand < 2 ** (bit_size - 1):
            raise ValueError(
                f"not enough {bit_size}-bit NTT primes for ring 2^{ring_n}"
            )
        if is_prime(cand) and cand not in excl:
            if skipped < skip:
                skipped += 1
                continue
            out.append(cand)
    return tuple(out)


def primitive_root_2n(p: int, ring_n: int) -> int:
    """A primitive (2*ring_n)-th root of unity mod p (psi with psi^n = -1)."""
    m = 2 * ring_n
    assert (p - 1) % m == 0
    exp = (p - 1) // m
    x = 2
    while True:
        psi = pow(x, exp, p)
        # psi has order dividing 2n; primitive iff psi^n == -1.
        if pow(psi, ring_n, p) == p - 1:
            return psi
        x += 1
