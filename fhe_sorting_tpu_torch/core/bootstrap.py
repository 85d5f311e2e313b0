"""CKKS bootstrapping: ModRaise -> CoeffsToSlots -> EvalMod -> SlotsToCoeffs.

Port of `fhe_sorting_tpu/core/bootstrap.py`, built from this package's own
primitives (the bitonic and k-way sorts need it):

  * ModRaise: drop to a single bottom prime q0 ~ Delta, INTT, exact centered
    base-extension of each coefficient to the full chain, NTT.  The raised
    ciphertext encrypts a + q0*I with |I| <~ K (ternary secret).
  * CoeffsToSlots: the level-budget FFT-factored inverse embedding
    (core/fft_factors.py).  Both real coefficient halves ride one complex
    vector c~ = c_lo + i*c_hi (exact because zeta^{e_t*n/2} = i for every
    slot root), so one factored transform chain of `level_budget[0]` sparse
    BSGS stages + a conjugation recovers c_lo/q0 and c_hi/q0.  Budget 1
    degenerates to the single dense transform.
  * EvalMod: Chebyshev approximation of sin(2*pi*u)/(2*pi) on [-K, K]
    removes the q0*I multiples (messages must satisfy |m| <= msg_ratio/2
    so the small-angle regime holds; callers scale down accordingly).
  * SlotsToCoeffs: m1 + i*m2 repacked by one complex plaintext multiply,
    then the forward factored chain (`level_budget[1]` stages).

Intermediate slot vectors live in bit-reversed coefficient order - the
factored stages absorb the FFT permutation, and EvalMod is elementwise so
the order cancels between C2S and S2C (standard trick; the permutation is
never materialized).
"""

from __future__ import annotations

import numpy as np

import torch

from ..ops.chebyshev import ChebyshevPS, chebyshev_fit
from ..ops.linear_transform import LinearTransform
from .cipher import Ciphertext
from .evaluator import Evaluator
from .fft_factors import c2s_factors, s2c_factors
from .modmath import add_mod, mulmod, sub_mod


class Bootstrapper:
    def __init__(self, ev: Evaluator, slots: int | None = None,
                 K: float = 25.0, sin_degree: int = 255,
                 level_budget: tuple = (1, 1), asin_terms: int = 0,
                 rot=None, double_angle: int = 0):
        """`rot`: optional RotationComposer routing every C2S/S2C rotation
        (see LinearTransform.from_diagonals): for rings where keying every
        BSGS index (`required_rotations`) would not fit the device.

        `double_angle`: r > 0 selects the UNIFORM-ternary-secret EvalMod
        shape (K = 512 at large rings): fit
        cos((2*pi*K*v - pi/2)/2^r) at `sin_degree`, then apply r
        double-angle steps y <- 2y^2 - 1 to recover sin(2*pi*K*v).  This
        keeps the Chebyshev degree ~O(K/2^r) instead of O(K), at r extra
        levels - the only way |I| <~ sqrt(n) of a dense secret fits an
        evaluable polynomial."""
        self.ev = ev
        self.rot = rot
        self.double_angle = double_angle
        ctx = ev.ctx
        n = ctx.params.ring_n
        nh = n // 2
        # Sparse packing (slots < n/2): `encode_coeffs` tiles the slot
        # vector to full packing (the SetSlots re-interpretation), so a sparsely packed ciphertext IS a full
        # ciphertext whose slot vector is periodic.  The full-packing
        # transforms preserve that periodicity slot-wise, so sparse
        # bootstrap = full bootstrap + slots-metadata restore at the end
        self.slots = nh
        # ModRaise base: the product of the bottom `comp` primes (~ Delta).
        # comp=1 raises from q0; comp=2 (composite scaling, the flagship
        # chain) reconstructs each coefficient from the bottom PAIR by CRT
        # on the device and extends the centered representative.
        self.comp = ctx.params.comp
        assert self.comp in (1, 2), "bootstrap ModRaise supports comp <= 2"
        self.K = K
        self.q0 = 1
        for p in ctx.q_primes[: self.comp]:
            self.q0 *= p
        self.level_budget = level_budget

        # C2S chain: u_br = (s0/q0) * [prod groups] * w, 1/nh and s0/q0
        # folded into the first-applied group's diagonals
        f = float(ctx.scale_dec(0)) / float(self.q0)
        groups = c2s_factors(n, level_budget[0])
        self.c2s = [
            LinearTransform.from_diagonals(
                ev, g, nh, scale=(f if i == 0 else None), rot=rot)
            for i, g in enumerate(groups)
        ]
        # S2C groups are scaled at apply time (factor depends on the input
        # ciphertext's bottom scale), cached per scale
        self._s2c_groups = s2c_factors(n, level_budget[1])
        self._s2c_cache = {}

        # EvalMod: h(v) = sin(2 pi K v) / (2 pi) on [-1, 1] (sparse shape),
        # or the double-angle seed cos((2 pi K v - pi/2)/2^r) (uniform)
        if double_angle > 0:
            self.sin_coeffs = chebyshev_fit(
                lambda v: np.cos((2 * np.pi * K * v - np.pi / 2)
                                 / (1 << double_angle)), sin_degree
            )
        else:
            self.sin_coeffs = chebyshev_fit(
                lambda v: np.sin(2 * np.pi * K * v) / (2 * np.pi), sin_degree
            )
        # Small-angle correction: sin distorts the message by
        # sin(2 pi m)/(2 pi) = m - (2 pi)^2 m^3/6 + ...; inverting with the
        # arcsine series y + (2 pi)^2 y^3/6 + 3 (2 pi)^4 y^5/40 pushes the
        # residual to O(m^5)/O(m^7) (message ranges well beyond
        # |m| << 1/2 pi).
        self.asin_terms = asin_terms
        self.ps = ChebyshevPS(ev)

    # ------------------------------------------------------------------

    def required_rotations(self) -> set:
        idx = set()
        for lt in self.c2s:
            idx |= lt.required_rotations()
        for g in self._s2c_groups:
            idx |= LinearTransform.from_diagonals(
                self.ev, g, self.slots
            ).required_rotations()
        return idx

    def _mod_raise(self, ct: Ciphertext) -> Ciphertext:
        """Bottom-`comp`-limb ct -> full-chain level-0 ct.

        comp=1: centered extension of the single-limb residue.
        comp=2: per-coefficient CRT x = x0 + q0*t, t = (x1-x0)*q0^{-1} mod
        q1, extended as x mod p = x0 + (q0 mod p)*t; centering subtracts
        q0*q1 when t >= q1/2 (the boundary slop shifts the q0*q1-multiple
        I by at most 1, which EvalMod's [-K, K] range absorbs).

        Residues are int64, so every step is `%`, a compare and a
        `torch.where` on the limb planes; the planes that come out equal the
        reference's bit for bit."""
        ev = self.ev
        ctx = ev.ctx
        L0 = ctx.num_q
        c = self.comp
        p_all = ctx.p_active(0)                                  # [L0, 1]
        q0_mod = ctx.tensor([[self.q0 % p] for p in ctx.q_primes[:L0]])
        x = ev._intt(ct.data[:, :c, :], ctx.limbs_range(0, c))   # [2, c, n] coeff
        if c == 1:
            xm = torch.remainder(x, p_all)                       # [2, L0, n]
            centre = x >= (self.q0 + 1) // 2
        else:
            p0, p1 = ctx.q_primes[0], ctx.q_primes[1]
            x0, x1 = x[:, :1, :], x[:, 1:2, :]                   # mod p0, mod p1
            # t = (x1 - x0) * p0^{-1} mod p1, in [0, p1)
            t = torch.remainder(torch.remainder(x1 - x0, p1) * pow(p0, -1, p1), p1)
            # x = x0 + p0*t on every target prime
            p0_mod = ctx.tensor([[p0 % p] for p in ctx.q_primes[:L0]])
            xm = add_mod(torch.remainder(x0, p_all),
                         mulmod(torch.remainder(t, p_all), p0_mod, p_all), p_all)
            centre = t >= (p1 + 1) // 2
        ext = torch.where(centre, sub_mod(xm, q0_mod, p_all), xm)
        return Ciphertext(ev._ntt(ext, ctx.active_limbs(0)), 0, 1, ct.slots)

    def _eval_mod(self, v: Ciphertext) -> Ciphertext:
        """sin(2 pi K v)/(2 pi) with `asin_terms` arcsine correction terms."""
        ev = self.ev
        y = self.ps.evaluate(v, self.sin_coeffs)
        if self.double_angle > 0:
            # y = cos((2 pi K v - pi/2)/2^r) -> r doublings -> sin(2 pi K v)
            for _ in range(self.double_angle):
                y = ev.sub(ev.mult(ev.square(y), 2.0), 1.0)
            # m = arcsin(y)/(2 pi): Horner in t = y^2, with 1/(2 pi) folded
            # into the polynomial coefficients (no extra level)
            inv2pi = 1.0 / (2.0 * np.pi)
            coefs = [c * inv2pi
                     for c in (1.0, 1.0 / 6.0, 3.0 / 40.0, 15.0 / 336.0)
                     ][: min(self.asin_terms, 3) + 1]
            if len(coefs) == 1:
                return ev.mult(y, coefs[0])
            t = ev.square(y)
            poly = None
            for c in reversed(coefs):
                if poly is None:
                    poly = c                       # highest coefficient
                elif isinstance(poly, float):
                    poly = ev.add(ev.mult(t, poly), c)
                else:
                    poly = ev.add(ev.mult(poly, t), c)
            return ev.mult(y, poly)
        if self.asin_terms == 0:
            return y
        w = (2.0 * np.pi) ** 2
        # m ~ y * (1 + y^2*(w/6 + y^2*(3w^2/40 + y^2 * 15w^3/336))),
        # Horner in y^2 (arcsin(x)/x = 1 + x^2/6 + 3x^4/40 + 15x^6/336 ...)
        t = ev.square(y)
        if self.asin_terms >= 3:
            inner = ev.add(ev.mult(t, 15.0 * w ** 3 / 336.0),
                           3.0 * w * w / 40.0)
            inner = ev.add(ev.mult(inner, t), w / 6.0)
            poly = ev.add(ev.mult(inner, t), 1.0)
        elif self.asin_terms >= 2:
            inner = ev.add(ev.mult(t, 3.0 * w * w / 40.0), w / 6.0)
            poly = ev.add(ev.mult(inner, t), 1.0)
        else:
            poly = ev.add(ev.mult(t, w / 6.0), 1.0)
        return ev.mult(y, poly)

    def bootstrap(self, ct: Ciphertext, msg_scale_down: float | None = None
                  ) -> Ciphertext:
        """Refresh `ct` to a low level.  |message| must be < 0.5 (callers
        with larger ranges pass msg_scale_down to pre-scale and the inverse
        is applied at the end)."""
        ev = self.ev
        ctx = ev.ctx
        nh = self.slots
        slots_in = ct.slots  # sparse inputs ride the full-packing pipeline

        if msg_scale_down:
            ct = ev.mult(ct, 1.0 / msg_scale_down)
        # descend to the single bottom prime
        if ct.sdeg == 2:
            ct = ev.rescale(ct)
        s_bottom = float(ctx.scale_dec(ct.level))
        ct1 = Ciphertext(ct.data[:, : self.comp, :], ct.level, 1, nh)

        raised = self._mod_raise(ct1)

        # CoeffsToSlots: factored chain, then re/im split by conjugation
        u = raised
        for lt in self.c2s:
            u = lt.apply(u)
        uc = ev.conjugate(u)
        u1 = ev.mult(ev.add(u, uc), 0.5)                       # c_lo_br / q0
        u2 = ev.mult_plain_at(
            ev.sub(u, uc), np.full(nh, -0.5j)
        )                                                      # c_hi_br / q0

        # EvalMod: v = u / K, then sin series (+ optional arcsine correction)
        m1 = self._eval_mod(ev.mult(u1, 1.0 / self.K))
        m2 = self._eval_mod(ev.mult(u2, 1.0 / self.K))

        # SlotsToCoeffs: pack m1 + i m2, then the forward factored chain
        m1, m2 = ev.align_group([m1, m2])
        m2i = ev.mult_plain_at(m2, np.full(nh, 1j))
        if m1.sdeg != m2i.sdeg or m1.level != m2i.level:
            m1, m2i = ev.align_group([m1, m2i])
        mhat = ev.add(m1, m2i)

        f = float(self.q0) / s_bottom
        key = round(f, 12)
        if key not in self._s2c_cache:
            self._s2c_cache[key] = [
                LinearTransform.from_diagonals(
                    ev, g, nh, scale=(f if i == 0 else None), rot=self.rot
                )
                for i, g in enumerate(self._s2c_groups)
            ]
        out = mhat
        for lt in self._s2c_cache[key]:
            out = lt.apply(out)
        if msg_scale_down:
            out = ev.mult(out, msg_scale_down)
        return Ciphertext(out.data, out.level, out.sdeg, slots_in)
