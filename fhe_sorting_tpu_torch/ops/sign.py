"""Composite-polynomial sign approximation for encrypted comparisons.

Port of `fhe_sorting_tpu/ops/sign.py`: the f_n/g_n composition from
"Efficient Homomorphic Comparison Methods with Optimal Complexity"
(Cheon-Kim-Kim, eprint 2019/1234) with the published constants:

  CompositeSign<3>: g_3 = (4589x - 16577x^3 + 25614x^5 - 12860x^7)/2^10
                    f_3 = (35x - 35x^3 + 21x^5 - 5x^7)/2^4      (3 levels each)
  CompositeSign<4>: g_4 = degree-27 Chebyshev series, f_4 = degree-15 odd
                    polynomial with dyadic coefficients              (4 levels)

plus the MEHP24 `sign_adv` variant whose final f_3 iteration folds the
(s+1)/2 affine map into halved coefficients.

The loop applies dg iterations of g then df of f; `SignConfig.mult_depth`
keeps the "100 = no bootstrap" sentinel: when `mult_depth < 100` and a
`bootstrap_fn` is supplied, the iteration loop refreshes the ciphertext
whenever the remaining depth cannot cover the next factor.  The port has no
bootstrap of its own yet; the argument is passed through.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass

import numpy as np

from ..core.cipher import Ciphertext
from .chebyshev import ChebyshevPS, chebyshev_fit, eval_chebyshev_function

G3 = (4589.0 / 1024.0, -16577.0 / 1024.0, 25614.0 / 1024.0, -12860.0 / 1024.0)
F3 = (35.0 / 16.0, -35.0 / 16.0, 21.0 / 16.0, -5.0 / 16.0)
F3_FINAL = tuple(c / 2.0 for c in F3)  # + 0.5 constant, see signAdv

# Chebyshev-basis coefficients of g_4 (odd series, degree 27).
G4_CHEB = (
    0.0, 1.077117252745569, 0.0, -0.36166113998402755,
    0.0, 0.2137420717859748, 0.0, -0.15635204788780485,
    0.0, 0.11749645501187332, 0.0, -0.10074154666447852,
    0.0, 0.08002086947825496, 0.0, -0.07533558758484624,
    0.0, 0.059514472116534836, 0.0, -0.06146663712787884,
    0.0, 0.04570084927999001, 0.0, -0.05403683682999072,
    0.0, 0.03364293851188723, 0.0, -0.054459493266273494,
)

# Odd monomial coefficients of f_4 (degree 15, dyadic).
F4 = (
    3.14208984375, -7.33154296875, 13.19677734375, -15.71044921875,
    12.21923828125, -5.99853515625, 1.69189453125, -0.20947265625,
)


class SignFunc(enum.Enum):
    CompositeSign = "CompositeSign"
    SignumPolycircuit = "SignumPolycircuit"
    NaiveDiscrete = "NaiveDiscrete"
    Tanh = "Tanh"


@dataclass(frozen=True)
class CompositeSignConfig:
    n: int = 3
    dg: int = 2
    df: int = 2


@dataclass(frozen=True)
class SignConfig:
    compos: CompositeSignConfig = CompositeSignConfig()
    mult_depth: int = 100  # 100 sentinel: never bootstrap


def eval_odd_poly7(ev, x: Ciphertext, coeffs) -> Ciphertext:
    """c1 x + c3 x^3 + c5 x^5 + c7 x^7 in 3 levels:
    y = (c1 x + (c3 x) x^2) + ((c5 x) + (c7 x) x^2) x^4."""
    c1, c3, c5, c7 = coeffs
    x2 = ev.square(x)
    x4 = ev.square(x2)
    y = ev.mult(x, c1)
    y = ev.add(y, ev.mult(ev.mult(x, c3), x2))
    tail = ev.add(ev.mult(x, c5), ev.mult(ev.mult(x, c7), x2))
    return ev.add(y, ev.mult(tail, x4))


def eval_odd_poly15(ev, x: Ciphertext, coeffs) -> Ciphertext:
    """Degree-15 odd polynomial in 4 levels (the f_4 shape)."""
    c1, c3, c5, c7, c9, c11, c13, c15 = coeffs
    x2 = ev.square(x)
    x4 = ev.square(x2)
    x8 = ev.square(x4)
    y = ev.add(ev.mult(x, c1), ev.mult(ev.mult(x, c3), x2))
    y = ev.add(y, ev.mult(ev.add(ev.mult(x, c5), ev.mult(ev.mult(x, c7), x2)), x4))
    t1 = ev.add(ev.mult(x, c9), ev.mult(ev.mult(x, c11), x2))
    t2 = ev.add(ev.mult(x, c13), ev.mult(ev.mult(x, c15), x2))
    t1 = ev.add(t1, ev.mult(t2, x4))
    return ev.add(y, ev.mult(t1, x8))


def composite_sign(ev, x: Ciphertext, cfg: SignConfig,
                   bootstrap_fn=None, final_scale: float = 1.0) -> Ciphertext:
    """sign(x) ~ f^{df} o g^{dg} (x); x in [-1, 1].

    Lazy bootstrap: when `cfg.mult_depth` is a real
    depth (not the 100 sentinel) and a `bootstrap_fn` is given, the iteration
    loop refreshes `y` whenever the remaining depth cannot cover the next
    polynomial factor plus the rescale needed to stay usable afterwards.

    `final_scale` multiplies the LAST iteration's coefficients, returning
    final_scale * sign(x) without the extra rescale level a separate scalar
    multiply would cost (the generalization of MEHP24's halved-coefficient
    signAdv trick) - Comparison.compare folds its post_scale here."""
    n, dg, df = cfg.compos.n, cfg.compos.dg, cfg.compos.df
    if n == 3:
        need_g = need_f = 3
    elif n == 4:
        need_g, need_f = 6, 4   # deg-27 Chebyshev PS / deg-15 odd poly
    else:
        raise ValueError(f"unsupported composite sign n={n}")

    def maybe_boot(y: Ciphertext, need: int) -> Ciphertext:
        if cfg.mult_depth >= 100 or bootstrap_fn is None:
            return y
        if cfg.mult_depth - y.level < need + 1:
            y = bootstrap_fn(y)
        return y

    def scaled(coeffs, is_last: bool):
        if not is_last or final_scale == 1.0:
            return coeffs
        return tuple(c * final_scale for c in coeffs)

    total = dg + df
    if total == 0:
        return ev.mult(x, final_scale) if final_scale != 1.0 else x
    it = 0
    y = x
    if n == 3:
        for _ in range(dg):
            it += 1
            y = eval_odd_poly7(ev, maybe_boot(y, need_g),
                               scaled(G3, it == total))
        for _ in range(df):
            it += 1
            y = eval_odd_poly7(ev, maybe_boot(y, need_f),
                               scaled(F3, it == total))
    else:
        ps = ChebyshevPS(ev)
        for _ in range(dg):
            it += 1
            y = ps.evaluate(maybe_boot(y, need_g),
                            scaled(G4_CHEB, it == total))
        for _ in range(df):
            it += 1
            y = eval_odd_poly15(ev, maybe_boot(y, need_f),
                                scaled(F4, it == total))
    return y


def sign_adv(ev, x: Ciphertext, dg: int, df: int) -> Ciphertext:
    """MEHP24 signAdv: g_3^{dg} then f_3^{df} with the last f folding in the
    (s+1)/2 map: returns ~ 1_{x>0} directly."""
    y = x
    for _ in range(dg):
        y = eval_odd_poly7(ev, y, G3)
    for _ in range(df - 1):
        y = eval_odd_poly7(ev, y, F3)
    y = eval_odd_poly7(ev, y, F3_FINAL)
    return ev.add(y, 0.5)


def signum_polycircuit_coeffs(degree: int = 1023):
    """Chebyshev-node interpolation of sign(x) at degree 1023 (a node fit,
    which at finite degree differs from the analytic series
    c_{2j+1} = (4/pi)(-1)^j/(2j+1) in the 6th decimal)."""
    c = chebyshev_fit(lambda v: -1.0 if v < 0 else (1.0 if v > 0 else 0.0),
                      degree)
    c[::2] = 0.0  # odd function: even terms are interpolation noise
    return np.asarray(c)


def signum_polycircuit(ev, x: Ciphertext,
                       degree: int = 1023) -> Ciphertext:
    """Degree-1023 Chebyshev signum through Paterson-Stockmeyer
    (~2 sqrt(d) ct-ct mults instead of d)."""
    return ChebyshevPS(ev).evaluate(x, signum_polycircuit_coeffs(degree))


def sign(ev, x: Ciphertext, func: SignFunc, cfg: SignConfig,
         bootstrap_fn=None, final_scale: float = 1.0) -> Ciphertext:
    """Dispatcher.  `final_scale` scales the result for free by folding
    into the last polynomial's coefficients."""
    if func == SignFunc.CompositeSign:
        return composite_sign(ev, x, cfg, bootstrap_fn=bootstrap_fn,
                              final_scale=final_scale)
    if final_scale != 1.0:
        return ev.mult(
            sign(ev, x, func, cfg, bootstrap_fn=bootstrap_fn), final_scale
        )
    if func == SignFunc.SignumPolycircuit:
        return signum_polycircuit(ev, x)
    if func == SignFunc.NaiveDiscrete:
        return eval_chebyshev_function(
            ev, lambda v: -1.0 if v < 0 else (1.0 if v > 0 else 0.0), x, 119
        )
    if func == SignFunc.Tanh:
        return eval_chebyshev_function(ev, lambda v: math.tanh(100 * v), x, 1006)
    raise NotImplementedError(func)
