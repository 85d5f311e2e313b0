"""Chebyshev-basis polynomial evaluation on ciphertexts (Paterson-Stockmeyer).

Port of `fhe_sorting_tpu/ops/chebyshev.py`.  The PS plan (baby/giant steps,
Chebyshev divmod tree) is computed on the host with numpy float64; the
ciphertext work is ~2*sqrt(d) multiplies plus one batched `combo` per chunk
of leaf segments.

Coefficient convention: f(x) = sum_i c[i] * T_i(x) on [-1, 1] (plain
numpy.polynomial.chebyshev convention, no half-c0).
"""

from __future__ import annotations

import numpy as np

from ..core.cipher import Ciphertext


def _cheb_divmod_tn(c: np.ndarray, n: int):
    """Divide sum c_i T_i by T_n: returns (q, r) with f = q*T_n + r.

    Uses T_i = 2*T_n*T_{i-n} - T_{|i-2n|} for i > n and T_n*T_0 = T_n.
    """
    d = len(c) - 1
    q = np.zeros(max(d - n + 1, 1), dtype=np.float64)
    r = c.astype(np.float64).copy()
    for i in range(d, n, -1):
        ci = r[i]
        if ci == 0.0:
            continue
        r[i] = 0.0
        q[i - n] += 2.0 * ci
        r[abs(i - 2 * n)] -= ci
    q[0] += r[n]
    r[n] = 0.0
    return np.trim_zeros(q, "b") if q.any() else q[:1], r[:n]


def _trim(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, dtype=np.float64)
    nz = np.nonzero(c)[0]
    return c[: nz[-1] + 1] if len(nz) else c[:1]


class ChebyshevPS:
    """Reusable PS evaluator bound to an evaluator."""

    def __init__(self, ev):
        self.ev = ev

    def _plan_shape(self, coeffs):
        """(trimmed coeffs, degree, baby count k, giant degrees)."""
        c = _trim(np.asarray(coeffs, dtype=np.float64))
        d = len(c) - 1
        if d == 0:
            raise ValueError("constant polynomial: nothing to evaluate")
        k = 1 << max(1, int(round(np.log2(max(d, 2) ** 0.5))))
        gs = []
        g = 2 * k
        while g <= d:
            gs.append(g)
            g *= 2
        return c, d, k, gs

    def powers(self, x: Ciphertext, coeffs) -> list:
        """The shared Chebyshev powers [T_1..T_k, T_2k, T_4k, ...]."""
        ev = self.ev
        _, d, k, gs = self._plan_shape(coeffs)

        # doubling by self-addition costs no level (a scalar 2 would)
        def dbl(c: Ciphertext) -> Ciphertext:
            return ev.add(c, c)

        babies = {1: x}
        for i in range(2, k + 1):
            if i % 2 == 0:
                babies[i] = ev.sub(dbl(ev.square(babies[i // 2])), 1.0)
            else:
                a, b = babies[(i + 1) // 2], babies[i // 2]
                babies[i] = ev.sub(dbl(ev.mult(a, b)), x)

        giants = {k: babies[k]}
        for g in gs:
            giants[g] = ev.sub(dbl(ev.square(giants[g // 2])), 1.0)
        return [babies[i] for i in range(1, k + 1)] + [giants[g] for g in gs]

    def combine(self, pows: list, coeffs) -> Ciphertext:
        """Leaf linear combinations + divmod-tree fold over `powers`."""
        c, d, k, gs = self._plan_shape(coeffs)
        babies = {i + 1: pows[i] for i in range(k)}
        giants = {k: babies[k]}
        for idx, g in enumerate(gs):
            giants[g] = pows[k + idx]
        return self._combine_impl(c, k, babies, giants)

    def evaluate(self, x: Ciphertext, coeffs) -> Ciphertext:
        return self.combine(self.powers(x, coeffs), coeffs)

    def _combine_impl(self, c, k, babies, giants) -> Ciphertext:
        ev = self.ev
        leaves: list = []

        def plan(cc: np.ndarray):
            cc = _trim(cc)
            deg = len(cc) - 1
            if deg == 0:
                return ("const", float(cc[0]))
            if deg <= k:
                leaves.append(cc)
                return ("leaf", len(leaves) - 1)
            gg = k
            while 2 * gg <= deg:
                gg *= 2
            q, r = _cheb_divmod_tn(cc, gg)
            qn = plan(q)
            rr = _trim(r)
            rn = plan(rr) if (len(rr) > 1 or rr[0] != 0.0) else None
            return ("node", gg, qn, rn)

        root = plan(c)

        # every leaf segment (sum_i c_i T_i over the shared babies) in
        # batched combos; chunks bound the [R, 2, L, n] output at large rings
        leaf_cts: list = []
        if leaves:
            rows = np.zeros((len(leaves), k), dtype=np.float64)
            consts = np.zeros(len(leaves), dtype=np.float64)
            for i, cc in enumerate(leaves):
                rows[i, : len(cc) - 1] = cc[1:]
                consts[i] = cc[0]
            CH = 32 if ev.ctx.params.ring_n <= (1 << 14) else 8
            baby_list = [babies[i] for i in range(1, k + 1)]
            for lo in range(0, len(leaves), CH):
                leaf_cts += ev.combo(baby_list, rows[lo:lo + CH], consts[lo:lo + CH])

        def fold(node) -> Ciphertext:
            if node[0] == "const":
                return node[1]
            if node[0] == "leaf":
                return leaf_cts[node[1]]
            _, gg, qn, rn = node
            qc = fold(qn)
            out = ev.mult(giants[gg], qc) if isinstance(qc, float) else ev.mult(qc, giants[gg])
            if rn is not None:
                out = ev.add(out, fold(rn))
            return out

        out = fold(root)
        # plan and fold are recursive closures, each a reference cycle through
        # its own cell: unbind them, or the babies, giants and leaves they hold
        # stay on the device until the cyclic collector happens to run
        plan = fold = None
        return out


def chebyshev_fit(fn, degree: int) -> np.ndarray:
    """Chebyshev interpolation of `fn` on [-1,1] at Chebyshev nodes via DCT."""
    n = degree + 1
    theta = (np.arange(n) + 0.5) * np.pi / n
    ys = np.asarray([fn(float(v)) for v in np.cos(theta)], dtype=np.float64)
    ext = np.concatenate([ys, ys[::-1]])
    ph = np.exp(-1j * np.pi * np.arange(2 * n) / (2 * n))
    ck = (np.fft.fft(ext * 1.0) * ph).real[:n] / n
    ck[0] *= 0.5
    return ck


def eval_chebyshev_function(ev, fn, x: Ciphertext, degree: int) -> Ciphertext:
    """Fit `fn` on [-1, 1] at `degree` and evaluate the series on x."""
    return ChebyshevPS(ev).evaluate(x, chebyshev_fit(fn, degree))


def eval_chebyshev_function_ab(ev, fn, x: Ciphertext, degree: int,
                               a: float, b: float) -> Ciphertext:
    """`eval_chebyshev_function` with an explicit [a, b] domain: fits fn on
    [a, b], maps x affinely into [-1, 1] (one ct-scalar mult level), then PS."""
    if (a, b) == (-1.0, 1.0):
        return eval_chebyshev_function(ev, fn, x, degree)
    mid, half = (a + b) / 2.0, (b - a) / 2.0
    y = ev.mult(ev.sub(x, mid), 1.0 / half)
    return ChebyshevPS(ev).evaluate(
        y, chebyshev_fit(lambda t: fn(mid + half * t), degree))
