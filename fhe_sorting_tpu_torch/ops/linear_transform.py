"""Homomorphic linear transforms: BSGS diagonal matrix-vector products.

Port of `fhe_sorting_tpu/ops/linear_transform.py`.

Applies z -> M z (M a complex slots x slots matrix) to the slot vector of a
ciphertext using the baby-step/giant-step diagonal method:

    M z = sum_d diag_d(M) * rot(z, d)
        = sum_g rot( sum_b pdiag_{g,b} * rot(z, b), g )

with |baby| ~ |giant| ~ sqrt(s) rotations, the baby rotations sharing one
hoisted ModUp.  This is the workhorse of CKKS bootstrapping's
CoeffsToSlots/SlotsToCoeffs and is exposed as a standalone op.

Complex plaintext diagonals are supported because the canonical embedding
encoder handles complex slot vectors natively (conjugate pairs).
"""

from __future__ import annotations

import numpy as np

from ..core.cipher import Ciphertext
from ..core.evaluator import Evaluator


def matrix_diagonals(M: np.ndarray) -> dict:
    """Nonzero generalized diagonals d -> vector diag_d[i] = M[i, (i+d) % s]."""
    s = M.shape[0]
    out = {}
    for d in range(s):
        v = np.array([M[i, (i + d) % s] for i in range(s)])
        if np.any(np.abs(v) > 1e-14):
            out[d] = v
    return out


def rotation_indices_linear_transform(s: int) -> set:
    bs = max(1, int(np.sqrt(s)))
    idx = set(range(1, bs))
    idx |= {g for g in range(bs, s, bs)}
    return idx


class LinearTransform:
    """Precomputed BSGS application of a fixed matrix at a fixed level."""

    def __init__(self, ev: Evaluator, M: np.ndarray, slots: int):
        assert M.shape == (slots, slots)
        self.ev = ev
        self.slots = slots
        self.rot = None
        self.bs = max(1, int(np.sqrt(slots)))
        self.diags = matrix_diagonals(M)

    @classmethod
    def from_diagonals(cls, ev: Evaluator, diags: dict, slots: int,
                       scale=None, rot=None) -> "LinearTransform":
        """Build directly from {offset: vector} generalized diagonals (the
        FFT-factored bootstrap groups, core/fft_factors.py); baby-step count
        sized to the actual diagonal spread.

        `rot`: optional RotationComposer.  When set, EVERY rotation routes
        through it (no hoisting), so the transform runs with whatever key
        basis the composer manages, including its lazy on-device LRU pool.
        The factored bootstrap chains ask for many distinct BSGS indices
        (`required_rotations`) and one full-chain key is
        `utils.hbm_budget.ksk_bytes(ctx)` on the device; where the whole set
        does not fit, the composer keeps a bounded resident set instead."""
        self = cls.__new__(cls)
        self.ev = ev
        self.slots = slots
        self.rot = rot
        self.diags = ({d: np.asarray(v) * scale for d, v in diags.items()}
                      if scale is not None else dict(diags))
        nd = max(2, len(self.diags))
        self.bs = max(1, 1 << (int(np.ceil(np.log2(nd))) // 2))
        return self

    def required_rotations(self) -> set:
        idx = set()
        for d in self.diags:
            g = (d // self.bs) * self.bs
            b = d - g
            if b:
                idx.add(b)
            if g:
                idx.add(g)
        return idx

    def apply(self, ct: Ciphertext) -> Ciphertext:
        """One multiplicative level; O(sqrt(s)) rotations (babies hoisted)."""
        ev = self.ev
        s = self.slots
        bs = self.bs

        # group diagonals by giant step
        groups: dict = {}
        for d, vec in self.diags.items():
            g = (d // bs) * bs
            groups.setdefault(g, []).append((d - g, vec))

        pre = None if self.rot is not None else ev.rotate_precompute(ct)
        babies = {0: ct}

        def baby(b):
            if b not in babies:
                babies[b] = (self.rot.rotate(ct, b) if self.rot is not None
                             else ev.rotate_hoisted(ct, pre, b))
            return babies[b]

        out = None
        for g, items in sorted(groups.items()):
            inner = None
            for b, vec in items:
                # pre-rotate the diagonal so the giant rotation lands right
                pvec = np.roll(vec, g)
                cb = baby(b)
                term = ev.mult_plain_at(cb, pvec)
                inner = term if inner is None else ev.add(inner, term)
            if g:
                inner = (self.rot.rotate(inner, g) if self.rot is not None
                         else ev.rotate(inner, g))
            out = inner if out is None else ev.add(out, inner)
        return out
