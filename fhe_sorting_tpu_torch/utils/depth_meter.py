"""Metadata-only depth metering of DirectSort.

Port of `fhe_sorting_tpu/utils/depth_meter.py`, metering the port's own
sorts (`StagedDirectSort`, or the per-op `DirectSort` and its hybrid
placement): they run against a `MeterEvaluator` that implements the evaluator's (level, sdeg) transition rules on data-free
ciphertexts - no keys, no NTTs, milliseconds.  `max_level` after a run is
the least `mult_depth` a real context needs.

Transition rules (as `core/evaluator.py`):
  mult/square     : operands rescale first if sdeg==2, align levels, out sdeg 2
  mult by pt/scalar: rescale first if sdeg==2, out sdeg 2
  add/sub         : align levels and sdeg (1 -> 2 via a scalar)
  rescale         : sdeg 2 -> 1, level += 1   (the depth-consuming op)
  rotations/conj  : metadata no-ops
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np

from ..core.cipher import Ciphertext, Plaintext


@dataclass
class _MeterParams:
    ring_n: int


class _MeterCtx:
    device = None                        # no data: nothing runs on a device

    def __init__(self, ring_n: int):
        self.params = _MeterParams(ring_n)

    def galois_element_rot(self, r: int) -> int:  # composer compatibility
        return pow(5, r % (self.params.ring_n // 2), 2 * self.params.ring_n)


class _AllRot:
    def __contains__(self, g) -> bool:   # composer key probes
        return True

    def __getitem__(self, g):            # a data-free key (sharded offsets)
        return None


class _AllKeys:
    def __init__(self, ctx: _MeterCtx):
        self.ctx = ctx
        self.rot = _AllRot()


class MeterEvaluator:
    """Evaluator facade tracking only (level, sdeg)."""

    def __init__(self, ring_n: int):
        self.ctx = _MeterCtx(ring_n)
        self.keys = _AllKeys(self.ctx)
        self.op_stats: Counter = Counter()
        self.ntt_planes: Counter = Counter()     # none: no data is transformed
        self.max_level = 0
        self.mults = 0
        self.rotations = 0

    def rescale(self, a: Ciphertext) -> Ciphertext:
        lvl = a.level + 1
        self.max_level = max(self.max_level, lvl)
        return Ciphertext(None, lvl, 1, a.slots)

    def level_reduce(self, a: Ciphertext, target: int) -> Ciphertext:
        assert target >= a.level
        return Ciphertext(None, target, a.sdeg, a.slots)

    def adjust_level(self, a: Ciphertext, target: int) -> Ciphertext:
        if a.sdeg == 2:
            a = self.rescale(a)
        if a.level > target:
            raise ValueError("cannot adjust downwards")
        if a.level < target:
            # scalar mult to sdeg 2, rescale, then free limb drops
            a = self.rescale(Ciphertext(None, a.level, 2, a.slots))
            a = self.level_reduce(a, target)
        return a

    def _align(self, a: Ciphertext, b: Ciphertext):
        if a.level != b.level:
            if a.level < b.level:
                a = self.adjust_level(a, b.level)
            else:
                b = self.adjust_level(b, a.level)
        if a.sdeg != b.sdeg:
            if a.sdeg == 1:
                a = Ciphertext(None, a.level, 2, a.slots)
            else:
                b = Ciphertext(None, b.level, 2, b.slots)
        return a, b

    def add(self, a: Ciphertext, b) -> Ciphertext:
        if isinstance(b, Ciphertext):
            a, b = self._align(a, b)
        return Ciphertext(None, a.level, a.sdeg, a.slots)

    sub = add

    def rsub(self, b, a: Ciphertext) -> Ciphertext:
        return self.add(a, b)

    def negate(self, a: Ciphertext) -> Ciphertext:
        return a

    def add_many(self, cts) -> Ciphertext:
        out = cts[0]
        for c in cts[1:]:
            out = self.add(out, c)
        return out

    def align_group(self, cts):
        """Common (level, sdeg) for a group, as the evaluator's."""
        lvl = max(c.level for c in cts)
        out = [self.adjust_level(c, lvl) if c.level < lvl else c for c in cts]
        lvl = max(c.level for c in out)
        out = [self.adjust_level(c, lvl) if c.level < lvl else c for c in out]
        if len({c.sdeg for c in out}) > 1:
            out = [Ciphertext(None, c.level, 2, c.slots) for c in out]
        return out

    def mult(self, a: Ciphertext, b) -> Ciphertext:
        self.mults += 1
        if a.sdeg == 2:
            a = self.rescale(a)
        if isinstance(b, Ciphertext):
            if b.sdeg == 2:
                b = self.rescale(b)
            if a.level < b.level:
                a = self.adjust_level(a, b.level)
            elif b.level < a.level:
                b = self.adjust_level(b, a.level)
        return Ciphertext(None, a.level, 2, a.slots)

    def square(self, a: Ciphertext) -> Ciphertext:
        return self.mult(a, a)

    def mult_plain_at(self, a: Ciphertext, values, roll: int = 0) -> Ciphertext:
        return self.mult(a, 1.0)

    def make_plaintext(self, values, level: int, sdeg: int = 1,
                       slots: int | None = None) -> Plaintext:
        return Plaintext(None, level, sdeg, slots or 0)

    def combo(self, cts, rows, consts):
        """Inputs aligned to (max level incl. pending rescales, sdeg 1),
        outputs at sdeg 2."""
        tgt = max(c.level + (1 if c.sdeg == 2 else 0) for c in cts)
        self.max_level = max(self.max_level, tgt)
        R = np.asarray(rows).shape[0]
        self.mults += R
        return [Ciphertext(None, tgt, 2, cts[0].slots) for _ in range(R)]

    def rotate(self, a: Ciphertext, r: int) -> Ciphertext:
        self.rotations += 1
        return a

    def conjugate(self, a: Ciphertext) -> Ciphertext:
        return a

    def rotate_with_key(self, a: Ciphertext, r: int, ksk) -> Ciphertext:
        self.rotations += 1
        return a

    def rotate_precompute(self, a: Ciphertext):
        return None

    def rotate_hoisted(self, a: Ciphertext, pre, r: int) -> Ciphertext:
        self.rotations += 1
        return a


def measure_direct_sort_depth(N: int, ring_n: int, sign_cfg=None,
                              hybrid: bool = False, staged: bool = True) -> dict:
    """Required mult_depth (+ op counts) of DirectSort at (N, ring, cfg):
    the staged sort by default, the per-op `DirectSort.sort` with
    `staged=False`, its hybrid placement `sort_hybrid` with `hybrid=True`."""
    from ..models.direct_sort import DirectSort
    from ..ops.sign import SignConfig, SignFunc
    from ..parallel.direct_staged import StagedDirectSort

    ev = MeterEvaluator(ring_n)
    cfg = sign_cfg or SignConfig()
    ct = Ciphertext(None, 0, 1, N)
    if staged and not hybrid:
        out = StagedDirectSort(ev, N, cfg)(ct)
    else:
        srt = DirectSort(ev, N)
        out = (srt.sort_hybrid if hybrid else srt.sort)(ct, SignFunc.CompositeSign, cfg)
    # decrypt headroom: an sdeg-2 result at the bottom carries scale^2, which
    # exceeds the base limbs' modulus - reserve one more level
    return {
        "mult_depth": ev.max_level + (1 if out.sdeg == 2 else 0),
        "final_level": out.level,
        "ct_mults_and_rotations": (ev.mults, ev.rotations),
    }
