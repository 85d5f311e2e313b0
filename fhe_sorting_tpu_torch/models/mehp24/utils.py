"""MEHP24 matrix-in-slots utilities (N x N matrix packed row-major in N^2
slots).

Port of `fhe_sorting_tpu/models/mehp24/utils.py`: the log-depth rotate-add
ladders of "Efficient Ranking, Order Statistics, and Sorting under CKKS"
(Mazzone et al., arXiv 2412.15126).  A right rotation is `ev.rotate` with a
negative step.
"""

from __future__ import annotations

import math

import numpy as np

from ...core.cipher import Ciphertext
from ...core.evaluator import Evaluator
from ...ops.rotation import RotationComposer


def rotation_indices_mehp24(matrix_size: int) -> set:
    """Rotation steps of the matrix ladders (with the >256 chunking)."""
    sz = matrix_size
    idx = set()
    if matrix_size > 256:
        for i in range(matrix_size // 256):
            idx.add(i * 256)
            idx.add(-i * 256)
        sz = 256
    lg = int(math.log2(sz))
    for i in range(lg):
        idx.update({1 << i, -(1 << i), -(1 << (lg + i)), 1 << (lg + i)})
        t = sz * (sz - 1) // (1 << (i + 1))
        idx.update({t, -t})
    idx.discard(0)
    return idx


class MatrixOps:
    def __init__(self, ev: Evaluator, rot: RotationComposer, size: int):
        self.ev = ev
        self.rot = rot
        self.size = size
        self.lg = int(math.log2(size))
        self.slots = size * size

    def _pt_mask(self, mask: np.ndarray):
        return mask  # encoded lazily by mult_plain_at at the right level

    def mask_row(self, c: Ciphertext, row: int) -> Ciphertext:
        m = np.zeros(self.slots)
        m[self.size * row : self.size * (row + 1)] = 1.0
        return self.ev.mult_plain_at(c, m)

    def mask_column(self, c: Ciphertext, col: int) -> Ciphertext:
        m = np.zeros(self.slots)
        m[col :: self.size] = 1.0
        return self.ev.mult_plain_at(c, m)

    def replicate_row(self, c: Ciphertext) -> Ciphertext:
        for i in range(self.lg):
            c = self.ev.add(c, self.rot.rotate(c, -(1 << (self.lg + i))))
        return c

    def replicate_column(self, c: Ciphertext) -> Ciphertext:
        for i in range(self.lg):
            c = self.ev.add(c, self.rot.rotate(c, -(1 << i)))
        return c

    def sum_rows(self, c: Ciphertext, mask_output: bool = False,
                 output_row: int = 0) -> Ciphertext:
        for i in range(self.lg):
            c = self.ev.add(c, self.rot.rotate(c, -(1 << (self.lg + i))))
        if mask_output:
            c = self.mask_row(c, output_row)
        return c

    def sum_columns(self, c: Ciphertext, mask_output: bool = False) -> Ciphertext:
        for i in range(self.lg):
            c = self.ev.add(c, self.rot.rotate(c, 1 << i))
        if mask_output:
            c = self.mask_column(c, 0)
        return c

    def transpose_row(self, c: Ciphertext, mask_output: bool = False) -> Ciphertext:
        n = self.size
        for i in range(1, self.lg + 1):
            c = self.ev.add(c, self.rot.rotate(c, -(n * (n - 1) // (1 << i))))
        if mask_output:
            c = self.mask_column(c, 0)
        return c

    def transpose_column(self, c: Ciphertext, mask_output: bool = False) -> Ciphertext:
        n = self.size
        for i in range(1, self.lg + 1):
            c = self.ev.add(c, self.rot.rotate(c, n * (n - 1) // (1 << i)))
        if mask_output:
            c = self.mask_row(c, 0)
        return c


def split_ciphertext(ev: Evaluator, rot: RotationComposer, c: Ciphertext,
                     total_length: int, sub_length: int):
    """Mask out each sub-array and shift it to the front."""
    parts = []
    for i in range(total_length // sub_length):
        m = np.zeros(c.slots)
        m[i * sub_length : (i + 1) * sub_length] = 1.0
        part = ev.mult_plain_at(c, m)
        if i > 0:
            part = rot.rotate(part, i * sub_length)
        parts.append(part)
    return parts


def combine_ciphertext(ev: Evaluator, rot: RotationComposer, parts,
                       sub_length: int) -> Ciphertext:
    out = parts[0]
    for i in range(1, len(parts)):
        out = ev.add(out, rot.rotate(parts[i], -i * sub_length))
    return out


# ---------------------------------------------------------------------------
# Chebyshev-approximated comparisons, the shifted indicator and the
# depth->degree table
# ---------------------------------------------------------------------------


def depth2degree(depth: int) -> int:
    """Largest Chebyshev degree a Paterson-Stockmeyer evaluation fits in
    `depth` levels (used to pick comparison degrees)."""
    table = {3: 2, 4: 5, 5: 13, 6: 27, 7: 59, 8: 119, 9: 247, 10: 495,
             11: 1007, 12: 2031, 13: 4031, 14: 8127}
    return table.get(depth, -1)


def compare_cheb(ev: Evaluator, c1: Ciphertext, c2: Ciphertext, a: float,
                 b: float, degree: int, error: float = 1e-5) -> Ciphertext:
    """step(c1-c2) by Chebyshev fit on [a, b]."""
    from ...ops.chebyshev import eval_chebyshev_function_ab

    fn = lambda x: 1.0 if x > error else (0.5 if x >= -error else 0.0)
    return eval_chebyshev_function_ab(ev, fn, ev.sub(c1, c2), degree, a, b)


def equal_cheb(ev: Evaluator, c1: Ciphertext, c2: Ciphertext, a: float,
               b: float, degree: int, error: float = 1e-5) -> Ciphertext:
    """~1_{c1 == c2}."""
    from ...ops.chebyshev import eval_chebyshev_function_ab

    fn = lambda x: 1.0 if -error <= x <= error else 0.0
    return eval_chebyshev_function_ab(ev, fn, ev.sub(c1, c2), degree, a, b)


def compare_gt_cheb(ev: Evaluator, c1: Ciphertext, c2: Ciphertext, a: float,
                    b: float, degree: int, error: float = 1e-5) -> Ciphertext:
    """strict ~1_{c1 > c2}."""
    from ...ops.chebyshev import eval_chebyshev_function_ab

    fn = lambda x: 1.0 if x > error else 0.0
    return eval_chebyshev_function_ab(ev, fn, ev.sub(c1, c2), degree, a, b)


def indicator_cheb(ev: Evaluator, c: Ciphertext, a1: float, b1: float,
                   a: float, b: float, degree: int) -> Ciphertext:
    """~1_{a1 <= c <= b1} by direct fit."""
    from ...ops.chebyshev import eval_chebyshev_function_ab

    fn = lambda x: 0.0 if (x < a1 or x > b1) else 1.0
    return eval_chebyshev_function_ab(ev, fn, c, degree, a, b)


def indicator_adv_shifted(ev: Evaluator, c: Ciphertext, b: float,
                          dg: int, df: int) -> Ciphertext:
    """~1_{-(b+1)/2 < c < ... } for rank inputs
    already shifted to [-1, b]: s(2c/(b+1) + 2/(b+1) - 1) * s(-2c/(b+1)
    + 2/(b+1) + 1)."""
    from ...ops.sign import sign_adv

    f = 2.0 / (b + 1.0)
    c1 = ev.add(ev.mult(c, f), f - 1.0)
    c2 = ev.add(ev.mult(c, -f), f + 1.0)
    return ev.mult(sign_adv(ev, c1, dg, df), sign_adv(ev, c2, dg, df))
