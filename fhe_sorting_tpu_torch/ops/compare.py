"""Encrypted comparison and indicator built on the sign approximation.

Port of `fhe_sorting_tpu/ops/compare.py`: the Comparison class and the
MEHP24 indicator variant.
"""

from __future__ import annotations

from ..core.cipher import Ciphertext
from .sign import SignConfig, SignFunc, sign, sign_adv


class Comparison:
    def __init__(self, ev):
        self.ev = ev

    def compare(self, a: Ciphertext, b: Ciphertext, func: SignFunc,
                cfg: SignConfig, bootstrap_fn=None,
                post_scale: float = 0.5) -> Ciphertext:
        """(sign(a-b)+1)*post_scale: with the default 0.5 this is 1 if a>b,
        0 if a<b, 0.5 on ties.  Callers that would
        immediately scale the result fold the factor into `post_scale` to
        save a rescale level."""
        ev = self.ev
        diff = ev.sub(a, b)
        # (s+1)*ps = ps*s + ps: the ps factor folds into the final sign
        # iteration's coefficients (free), leaving only a scalar add
        s = sign(ev, diff, func, cfg, bootstrap_fn=bootstrap_fn,
                 final_scale=post_scale)
        return ev.add(s, post_scale)

    def indicator(self, x: Ciphertext, c: float, func: SignFunc,
                  cfg: SignConfig) -> Ciphertext:
        """~1_{|x| < c} from two signs."""
        ev = self.ev
        s1 = sign(ev, ev.add(x, c), func, cfg, final_scale=0.5)
        s2 = sign(ev, ev.sub(x, c), func, cfg, final_scale=0.5)
        c1 = ev.add(s1, 0.5)
        c2 = ev.add(s2, 0.5)
        return ev.mult(c1, ev.rsub(1.0, c2))

    def indicator_adv(self, x: Ciphertext, b: float, dg: int, df: int) -> Ciphertext:
        """MEHP24 indicatorAdv: ~1_{|x| < 1/2} after scaling by 1/b."""
        ev = self.ev
        tmp = ev.mult(x, 1.0 / b)
        c1 = sign_adv(ev, ev.add(tmp, 0.5 / b), dg, df)
        c2 = sign_adv(ev, ev.sub(tmp, 0.5 / b), dg, df)
        return ev.mult(c1, ev.rsub(1.0, c2))
