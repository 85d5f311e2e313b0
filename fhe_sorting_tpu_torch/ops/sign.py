"""Composite-polynomial sign approximation (the staged DirectSort's part).

Port of the CompositeSign<3> surface of `fhe_sorting_tpu/ops/sign.py`: the
f_3/g_3 constants of Cheon-Kim-Kim (eprint 2019/1234) and the 3-level odd
degree-7 evaluation.  The staged DirectSort applies dg iterations of g_3
then df of f_3 itself (`parallel/direct_staged.py`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from ..core.cipher import Ciphertext

G3 = (4589.0 / 1024.0, -16577.0 / 1024.0, 25614.0 / 1024.0, -12860.0 / 1024.0)
F3 = (35.0 / 16.0, -35.0 / 16.0, 21.0 / 16.0, -5.0 / 16.0)


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
