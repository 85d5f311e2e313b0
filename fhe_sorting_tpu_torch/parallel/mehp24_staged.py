"""MEHP24 multi-ciphertext sort for N > 256, as named eager stages.

Port of `fhe_sorting_tpu/parallel/mehp24_staged.py`.  The reference splits
arrays longer than 256 into 256-slot sub-ciphertexts and runs an O(k^2)
pairwise comparison triangle with Cv/Ch rank accumulators
(`sortLargeArrayFG`, mehp24_sort.cpp:607-645, 284-443).  At sub-length 256
a matrix tile is 65536 slots, a whole ring-2^17 ciphertext.  The sort runs
as stages over a reduced rotation-key set:

  * keys: signed powers of four {±4^i} and ±sub (`mehp24_staged_keys`);
    every matrix-ladder step (powers of two and the transpose steps
    2^a - 2^b) composes from at most four of them through the
    RotationComposer;
  * stages: split -> replicate (per part) -> pairwise signAdv compare ->
    rank fold -> per-(j, kk) index offset and indicator -> placement fold ->
    combine, each a `WholeGraph` as in `StagedDirectSort` (a CUDA graph on
    a CUDA context unless `graphs=False`, an eager call on the CPU).  A
    stage name is one graph, so a stage whose closure bakes in a host value
    (the index offset of part j) is named per value.
"""

from __future__ import annotations

import numpy as np

from ..core.cipher import Ciphertext
from ..models.mehp24.sort import Mehp24Sort
from ..models.mehp24.utils import combine_ciphertext, split_ciphertext
from ..ops.compare import Comparison
from ..ops.rotation import RotationComposer
from ..ops.sign import sign_adv
from .whole_graph import StageTable


def mehp24_staged_keys(sub: int, ring_n: int) -> set:
    """Signed powers of 4 covering the ladder range, plus ±sub."""
    nh = ring_n // 2
    idx = {sub, -sub}
    p = 1
    while p < nh:
        idx.update({p, -p})
        p *= 4
    idx.discard(0)
    return idx


class StagedMehp24Multi:
    """k-part MEHP24 triangle sort as named stages."""

    def __init__(self, ev, total: int, sub: int, dg_c: int, df_c: int, dg_i: int,
                 df_i: int, graphs: bool | None = None):
        self.ev = ev
        self.total = total
        self.sub = sub
        self.k = total // sub
        self.cfg = (dg_c, df_c, dg_i, df_i)
        rot = RotationComposer(ev, sorted(mehp24_staged_keys(sub, ev.ctx.params.ring_n)))
        self.model = Mehp24Sort(ev, total, sub_length=sub, rot=rot)
        self.rot = rot
        self.stages = StageTable(ev, graphs)
        self.verbose = False

    def _run(self, name: str, fn, cts):
        return self.stages.run(name, fn, cts, self.verbose)

    def __call__(self, ct: Ciphertext) -> Ciphertext:
        ev, mat = self.ev, self.model.mat
        k, sub, total = self.k, self.sub, self.total
        dg_c, df_c, dg_i, df_i = self.cfg

        parts = self._run("split", lambda cts: split_ciphertext(ev, self.rot, cts[0], total, sub),
                          [ct])

        def stage_repl(cts):
            c = cts[0]
            return [mat.replicate_row(c), mat.replicate_column(mat.transpose_row(c, True))]

        repl = [self._run("repl", stage_repl, [p]) for p in parts]
        replR = [r[0] for r in repl]
        replC = [r[1] for r in repl]

        # the pairwise triangle: each pair compared once, its transpose
        # reused as 1 - C_jk
        def stage_cmp(cts):
            return sign_adv(ev, ev.sub(cts[0], cts[1]), dg_c, df_c)

        def stage_acc(cts):
            return ev.add(cts[0], cts[1])

        Cv = [None] * k
        Ch = [None] * k
        for j in range(k):
            for kk in range(j, k):
                Cjk = self._run("cmp", stage_cmp, [replR[j], replC[kk]])
                Cv[j] = Cjk if Cv[j] is None else self._run("acc", stage_acc, [Cv[j], Cjk])
                if j != kk:
                    Ckj = self._run("flip", lambda cts: ev.rsub(1.0, cts[0]), [Cjk])
                    Ch[kk] = Ckj if Ch[kk] is None else self._run("acc", stage_acc, [Ch[kk], Ckj])

        def stage_sh(cts):
            shj = mat.sum_columns(cts[0], True)
            shj = mat.transpose_column(shj, True)
            return mat.replicate_row(shj)

        s = []
        for j in range(k):
            sj = self._run("sv", lambda cts: mat.sum_rows(cts[0]), [Cv[j]])
            if j > 0:
                shj = self._run("sh", stage_sh, [Ch[j]])
                sj = self._run("acc2", stage_acc, [sj, shj])
            s.append(sj)
        # one (level, sdeg) for every rank tile (s[0] has no Ch fold and is
        # shallower)
        if k > 1:
            s = self._run("align", lambda cts: ev.align_group(cts), s)

        comp = Comparison(ev)

        def stage_ind(cts):
            Rm, vr = cts
            return ev.mult(comp.indicator_adv(Rm, float(total), dg_i, df_i), vr)

        def stage_place(cts):
            acc = cts[0]
            for c in cts[1:]:
                acc = ev.add(acc, c)
            acc = mat.sum_columns(acc, True)
            return mat.transpose_column(acc, True)

        out_parts = []
        for j in range(k):
            subm = np.repeat(-(j * sub + np.arange(sub, dtype=np.float64)) - 0.5, sub)

            def stage_sub(cts, subm=subm):
                return ev.add(cts[0], ev.make_plaintext(subm, cts[0].level, cts[0].sdeg,
                                                        slots=sub * sub))

            terms = []
            for kk in range(k):
                Rm = self._run(f"Rsub{j}", stage_sub, [s[kk]])
                terms.append(self._run("ind", stage_ind, [Rm, replR[kk]]))
            out_parts.append(self._run("place", stage_place, terms))

        return self._run("combine", lambda cts: combine_ciphertext(ev, self.rot, cts, sub),
                         out_parts)
