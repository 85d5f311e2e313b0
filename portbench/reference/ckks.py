"""Plain RNS-CKKS decryption in NumPy and Python integers: the benchmark's reference.

It imports nothing of the program and takes nothing the program made.
From the configuration's parameters it derives the modulus chain and its
scales (the published rule: primes = 1 mod 2n glued to 2^scale_bits, see
`chain`), and it decrypts a ciphertext's residue planes with the secret
coefficients the benchmark drew itself.  Each step is done the slow, plain
way:

  * the negacyclic NTT as a twist by psi^i and a radix-2 cyclic transform,
    with evaluation slot j holding a(psi^(2 brev(j) + 1)) (bit-reversed
    order), psi the first primitive 2n-th root of unity found from x = 2
    upward as x^((p-1)/2n);
  * the CRT in Python integers, centred on (-Q/2, Q/2];
  * the canonical-embedding decode: slot t is the polynomial at
    zeta^(5^t), zeta = exp(i pi / n), divided by the scale.

The frozen arithmetic is the format both sides agree on; a program whose
chain or layout departs from it decrypts to noise here and is judged wrong.
"""

from __future__ import annotations

import math
from decimal import Decimal, getcontext

import numpy as np

getcontext().prec = 120

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin, exact below 3.3e24."""
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def chain(ring_n: int, mult_depth: int, scale_bits: int, comp: int, base_limbs: int,
          first_mod_bits: int | None = None):
    """(q primes, limb 0 first and the last limb dropped first; scales as
    Decimal per level 0..mult_depth).

    Level l+1's scale is level l's squared over the comp primes dropped at
    level l; each level's primes are taken nearest to 2^(scale_bits/comp)
    from the pool of primes = 1 mod 2n around it, the last of them nearest to
    what keeps the scale at 2^scale_bits.  The base limbs are the nearest
    primes left.  With `first_mod_bits`, the bottom `comp` base limbs (a
    bootstrap's ModRaise base) are then the largest primes p = 1 mod 2n with
    p - 1 <= 2^first_mod_bits and p < 2^31 that no limb took before, the
    largest first; the scales stay those of the level primes."""
    m = 2 * ring_n
    prime_bits = scale_bits // comp
    delta = Decimal(2) ** scale_bits
    unit = Decimal(2) ** prime_bits
    num_q = comp * mult_depth + base_limbs
    want = num_q + 4 * comp * mult_depth + 64
    pool, k_lo, k_hi = [], (1 << prime_bits) // m, (1 << prime_bits) // m + 1
    while len(pool) < want:
        if k_lo <= 0 and k_hi * m + 1 >= 2**31:
            break
        for k in (k_lo, k_hi):
            cand = k * m + 1
            if m < cand < 2**31 and is_prime(cand):
                pool.append(cand)
        k_lo -= 1
        k_hi += 1
    pool = sorted(set(pool))
    used = set()

    def nearest(target: Decimal) -> int:
        best = min((p for p in pool if p not in used), key=lambda p: abs(Decimal(p) - target))
        used.add(best)
        return best

    scales, drops = [delta], []
    for _ in range(mult_depth):
        s = scales[-1]
        lvl, prod = [], Decimal(1)
        for _ in range(comp - 1):
            q = nearest(unit)
            lvl.append(q)
            prod *= q
        q = nearest(s * s / delta / prod)
        lvl.append(q)
        prod *= q
        drops.append(lvl)
        scales.append(s * s / prod)
    base = [nearest(unit) for _ in range(base_limbs)]
    if first_mod_bits is not None:
        first = []
        for k in range((1 << first_mod_bits) // m, 0, -1):
            cand = k * m + 1
            if cand < 2**31 and cand not in used and is_prime(cand):
                first.append(cand)
                if len(first) == comp:
                    break
        else:
            raise ValueError(f"fewer than {comp} primes = 1 mod {m} up to 2^{first_mod_bits} + 1")
        base[:comp] = first
    return base + [q for lvl in reversed(drops) for q in reversed(lvl)], scales


def special_primes(ring_n: int, bits: int, count: int, exclude) -> list:
    """`count` primes = 1 mod 2n closest below 2^bits, not in `exclude`."""
    m, out, excl = 2 * ring_n, [], set(exclude)
    k = (2**bits - 2) // m
    while len(out) < count and k > 0:
        cand = k * m + 1
        k -= 1
        if is_prime(cand) and cand not in excl:
            out.append(cand)
    return out


def logqp_bits(primes) -> float:
    return sum(math.log2(p) for p in primes)


def _psi(p: int, n: int) -> int:
    e = (p - 1) // (2 * n)
    x = 2
    while True:
        psi = pow(x, e, p)
        if pow(psi, n, p) == p - 1:
            return psi
        x += 1


def _bitrev(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    return np.array([int(format(i, f"0{bits}b")[::-1], 2) for i in idx], dtype=np.int64) \
        if bits else idx


def _powers(w: int, count: int, p: int) -> np.ndarray:
    out = np.empty(count, dtype=np.int64)
    x = 1
    for i in range(count):
        out[i] = x
        x = x * w % p
    return out


def _cyclic(x: np.ndarray, w: int, p: int, rev: np.ndarray) -> np.ndarray:
    """sum_i x_i w^(ik) for every k: iterative radix-2 decimation in time."""
    n = len(x)
    x = x[rev].copy()
    wp = _powers(w, n // 2, p)
    m = 1
    while m < n:
        tw = wp[:: n // (2 * m)][:m]
        x = x.reshape(-1, 2 * m)
        u, v = x[:, :m], x[:, m:] * tw % p
        x = np.concatenate([(u + v) % p, (u - v) % p], axis=1)
        m *= 2
    return x.reshape(n)


class Ring:
    """The NTT of one prime at ring degree n."""

    def __init__(self, p: int, n: int):
        self.p, self.n = p, n
        psi = _psi(p, n)
        self.rev = _bitrev(n)
        self.tw = _powers(psi, n, p)
        self.itw = _powers(pow(psi, -1, p), n, p)
        self.w, self.iw = psi * psi % p, pow(psi * psi, -1, p)
        self.ninv = pow(n, -1, p)

    def ntt(self, a: np.ndarray) -> np.ndarray:
        """Coefficients -> evaluations in bit-reversed order."""
        x = np.asarray(a, dtype=np.int64) % self.p * self.tw % self.p
        return _cyclic(x, self.w, self.p, self.rev)[self.rev]

    def intt(self, e: np.ndarray) -> np.ndarray:
        x = _cyclic(np.asarray(e, dtype=np.int64)[self.rev], self.iw, self.p, self.rev)
        return x * self.ninv % self.p * self.itw % self.p


def crt_centered(res: np.ndarray, primes) -> np.ndarray:
    """Residue planes [L, n] -> the centred integers as float64 [n]."""
    Q = math.prod(primes)
    acc = np.zeros(res.shape[1], dtype=object)
    for r, q in zip(res, primes):
        Qi = Q // q
        acc = acc + (r * pow(Qi, -1, q) % q).astype(object) * Qi
    acc = acc % Q
    acc = np.where(acc > Q // 2, acc - Q, acc)
    return np.array([float(v) for v in acc], dtype=np.float64)


def decode(coeffs: np.ndarray, n: int, scale: float, slots: int) -> np.ndarray:
    """Slot t = the polynomial at zeta^(5^t), over the scale (complex)."""
    zeta_k = np.exp(1j * np.pi * np.arange(n) / n)
    ev = np.fft.ifft(coeffs * zeta_k) * n       # ev[j] = poly at zeta^(2j+1)
    e = np.array([pow(5, t, 2 * n) for t in range(slots)])
    return ev[(e - 1) // 2] / scale


class Decryptor:
    """Decrypts residue planes [2, L, n] of the chain that `params` states
    (`first_mod_bits` where it names one) with the secret coefficients `s`
    [n] in {-1, 0, 1}."""

    def __init__(self, params: dict, s: np.ndarray):
        self.n = int(params["ring_n"])
        first = params.get("first_mod_bits")
        self.q, self.scales = chain(self.n, int(params["mult_depth"]), int(params["scale_bits"]),
                                    int(params["comp"]), int(params["base_limbs"]),
                                    None if first is None else int(first))
        self.s = np.asarray(s, dtype=np.int64)
        self._rings, self._s_eval = {}, {}

    def _limb(self, i: int):
        if i not in self._rings:
            r = self._rings[i] = Ring(self.q[i], self.n)
            self._s_eval[i] = r.ntt(self.s)
        return self._rings[i], self._s_eval[i]

    def decrypt(self, data: np.ndarray, level: int, sdeg: int, slots: int) -> np.ndarray:
        """Real slot values [slots] of the ciphertext."""
        data = np.asarray(data, dtype=np.int64)
        L = data.shape[1]
        planes = []
        for i in range(L):
            ring, s_eval = self._limb(i)
            p = ring.p
            planes.append(ring.intt((data[0, i] + data[1, i] % p * s_eval) % p))
        coeffs = crt_centered(np.stack(planes), self.q[:L])
        return decode(coeffs, self.n, float(self.scales[level] ** sdeg), slots).real
