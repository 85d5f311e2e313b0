"""MEHP24 rank sort (Mazzone et al., USENIX Sec'25 / arXiv 2412.15126).

Port of `fhe_sorting_tpu/models/mehp24/sort.py`:
  * single-ciphertext sortFG: N x N replicate -> compare ->
    sumRows ranks -> indicator(rank - i - 0.5) -> mask*input -> sumColumns ->
    transpose.
  * multi-ciphertext sortFG: the j<=k comparison triangle with
    Cv/Ch accumulators; each pair compared once, the transpose reused via
    1 - C_jk.
  * sortLargeArrayFG: split -> multi-sortFG -> combine for
    N > matrix capacity.
"""

from __future__ import annotations

import numpy as np

from ...core.cipher import Ciphertext
from ...core.evaluator import Evaluator
from ...ops.compare import Comparison
from ...ops.rotation import RotationComposer
from ...ops.sign import SignConfig, SignFunc, sign_adv
from ..base import SortBase
from .utils import (
    MatrixOps, combine_ciphertext, rotation_indices_mehp24, split_ciphertext,
)


class Mehp24Sort(SortBase):
    """N <= matrix capacity: one ciphertext; larger N: split/tile."""

    def __init__(self, ev: Evaluator, N: int, sub_length: int | None = None,
                 rot: RotationComposer | None = None):
        super().__init__(ev, N)
        max_mat = int((ev.ctx.params.ring_n // 2) ** 0.5)
        self.sub_length = sub_length or min(N, max_mat, 256)
        assert self.sub_length ** 2 <= ev.ctx.params.ring_n // 2
        steps = rotation_indices_mehp24(self.sub_length) | {
            i * self.sub_length for i in range(1, N // self.sub_length)
        } | {-i * self.sub_length for i in range(1, N // self.sub_length)}
        self.rot = rot or RotationComposer(ev, steps)
        self.mat = MatrixOps(ev, self.rot, self.sub_length)

    # -- single ciphertext (N == sub_length) ------------------------------

    def sort_fg(self, c: Ciphertext, dg_c: int, df_c: int, dg_i: int,
                df_i: int) -> Ciphertext:
        """compareAdv = signAdv-based compare."""
        ev, mat, N = self.ev, self.mat, self.sub_length
        VR = mat.replicate_row(c)
        VC = mat.replicate_column(mat.transpose_row(c, True))
        C = sign_adv(ev, ev.sub(VR, VC), dg_c, df_c)
        return self._place_by_rank(C, VR, dg_i, df_i)

    def sort_fg_comp(self, c: Ciphertext, func: SignFunc, cfg: SignConfig,
                     dg_i: int, df_i: int) -> Ciphertext:
        """The variant taking the Comparison module."""
        ev, mat = self.ev, self.mat
        comp = Comparison(ev)
        VR = mat.replicate_row(c)
        VC = mat.replicate_column(mat.transpose_row(c, True))
        C = comp.compare(VR, VC, func, cfg)
        return self._place_by_rank(C, VR, dg_i, df_i)

    def _place_by_rank(self, C: Ciphertext, VR: Ciphertext, dg_i: int,
                       df_i: int) -> Ciphertext:
        ev, mat, N = self.ev, self.mat, self.sub_length
        R = mat.sum_rows(C)
        sub = np.repeat(-np.arange(N, dtype=np.float64) - 0.5, N)
        Rm = ev.add(R, ev.make_plaintext(sub, R.level, R.sdeg, slots=N * N))
        comp = Comparison(ev)
        M = comp.indicator_adv(Rm, float(N), dg_i, df_i)
        S = mat.sum_columns(ev.mult(M, VR), True)
        return mat.transpose_column(S, True)

    # -- multi-ciphertext tiling (N = k * sub_length) ---------------------

    def sort_fg_multi(self, parts, dg_c: int, df_c: int, dg_i: int,
                      df_i: int):
        """pairwise triangle with Cv/Ch."""
        ev, mat = self.ev, self.mat
        sub = self.sub_length
        k = len(parts)
        total = sub * k
        replR = [mat.replicate_row(c) for c in parts]
        replC = [mat.replicate_column(mat.transpose_row(c, True)) for c in parts]

        Cv = [None] * k
        Ch = [None] * k
        for j in range(k):
            for kk in range(j, k):
                Cjk = sign_adv(ev, ev.sub(replR[j], replC[kk]), dg_c, df_c)
                Cv[j] = Cjk if Cv[j] is None else ev.add(Cv[j], Cjk)
                if j != kk:
                    Ckj = ev.rsub(1.0, Cjk)
                    Ch[kk] = Ckj if Ch[kk] is None else ev.add(Ch[kk], Ckj)

        s = []
        for j in range(k):
            sj = mat.sum_rows(Cv[j])
            if j > 0:
                shj = mat.sum_columns(Ch[j], True)
                shj = mat.transpose_column(shj, True)
                shj = mat.replicate_row(shj)
                sj = ev.add(sj, shj)
            s.append(sj)

        comp = Comparison(ev)
        out = []
        for j in range(k):
            acc = None
            for kk in range(k):
                subm = np.repeat(
                    -(j * sub + np.arange(sub, dtype=np.float64)) - 0.5, sub
                )
                Rm = ev.add(
                    s[kk],
                    ev.make_plaintext(subm, s[kk].level, s[kk].sdeg,
                                      slots=sub * sub),
                )
                ind = ev.mult(
                    comp.indicator_adv(Rm, float(total), dg_i, df_i), replR[kk]
                )
                acc = ind if acc is None else ev.add(acc, ind)
            acc = mat.sum_columns(acc, True)
            out.append(mat.transpose_column(acc, True))
        return out

    def sort_large_array_fg(self, c: Ciphertext, dg_c: int, df_c: int,
                            dg_i: int, df_i: int) -> Ciphertext:
        """split -> multi sortFG -> combine."""
        parts = split_ciphertext(self.ev, self.rot, c, self.N, self.sub_length)
        sorted_parts = self.sort_fg_multi(parts, dg_c, df_c, dg_i, df_i)
        return combine_ciphertext(self.ev, self.rot, sorted_parts, self.sub_length)

    # -- SortBase API ------------------------------------------------------

    def sort(self, ct: Ciphertext, sign_func: SignFunc = SignFunc.CompositeSign,
             cfg: SignConfig | None = None) -> Ciphertext:
        cfg = cfg or SignConfig()
        dg_i = max(2, (self.N.bit_length()) // 2)  # dg_i=(log2N+1)/2 parity
        df_i = 2
        if self.N <= self.sub_length:
            return self.sort_fg(ct, cfg.compos.dg, cfg.compos.df, dg_i, df_i)
        return self.sort_large_array_fg(
            ct, cfg.compos.dg, cfg.compos.df, dg_i, df_i
        )
