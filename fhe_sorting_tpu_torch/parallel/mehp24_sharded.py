"""Multi-device MEHP24 sort: the pairwise-comparison triangle over a mesh.

Port of `fhe_sorting_tpu/parallel/mehp24_sharded.py`.  The reference runs
the N>256 MEHP24 path as OpenMP threads over the O(B^2) comparison triangle
of sub-ciphertexts (`mehp24_sort.cpp:284-443`).  Here the triangle's pairs
and the B^2 placement combos are split into contiguous blocks over the
ranks of the mesh's "batch" axis:

  * each rank builds the replicate/transpose ladders of the parts its pairs
    and combos touch;
  * it compares its pairs and accumulates Cv[j] / Ch[k] over them; a rank
    with no term at a position sends zeros, and one all-reduce mod p
    (`mesh.all_reduce_mod`) gives every rank the JAX package's sums, bit
    for bit;
  * it folds the ranks of the parts its combos need (every part through
    one program: part 0's Ch is zero, as in the JAX package), places its
    combos and accumulates them by output part; a second all-reduce sums
    them;
  * every rank sums the columns of each output part and transposes it, so
    each returns the B sorted parts.

Every rank needs at least one pair and one combo.
"""

from __future__ import annotations

import numpy as np

from ..models.mehp24.sort import Mehp24Sort
from ..ops.compare import Comparison
from ..ops.sign import sign_adv
from .mesh import all_reduce_mod, batch_sharding, make_mesh


class ShardedMehp24:
    """The multi-ciphertext sortFG with its triangle split over the mesh."""

    def __init__(self, ev, sub_length: int, num_parts: int, dg_c: int = 1, df_c: int = 1,
                 dg_i: int = 1, df_i: int = 1, mesh=None):
        self.ev = ev
        self.sub = sub_length
        self.B = num_parts
        self.cfg = (dg_c, df_c, dg_i, df_i)
        self.mesh = mesh or make_mesh()
        self.srt = Mehp24Sort(ev, sub_length * num_parts, sub_length=sub_length)
        B = num_parts
        pairs = [(j, k) for j in range(B) for k in range(j, B)]
        # by placed part k first: a rank's combos then share few rank folds
        combos = [(j, k) for k in range(B) for j in range(B)]
        self.pairs = [pairs[i] for i in batch_sharding(self.mesh, len(pairs))]
        self.combos = [combos[i] for i in batch_sharding(self.mesh, len(combos))]
        assert self.pairs and self.combos, "this rank has no pair or no combo of the triangle"

    def __call__(self, parts):
        """parts: B ciphertexts with the same metadata; returns the B sorted
        parts."""
        ev, mat, B, sub = self.ev, self.srt.mat, self.B, self.sub
        dg_c, df_c, dg_i, df_i = self.cfg
        ladders: dict = {}

        def ladder(k):
            if k not in ladders:
                ladders[k] = (mat.replicate_row(parts[k]),
                              mat.replicate_column(mat.transpose_row(parts[k], True)))
            return ladders[k]

        Cv, Ch = [None] * B, [None] * B
        for j, k in self.pairs:
            cjk = sign_adv(ev, ev.sub(ladder(j)[0], ladder(k)[1]), dg_c, df_c)
            Cv[j] = cjk if Cv[j] is None else ev.add(Cv[j], cjk)
            if j != k:
                ckj = ev.rsub(1.0, cjk)
                Ch[k] = ckj if Ch[k] is None else ev.add(Ch[k], ckj)
        # Cv at every position, Ch beside it (Ch[0] is all zeros)
        sums = all_reduce_mod(ev, Cv + Ch, self.mesh, "batch")
        Cv, Ch = sums[:B], sums[B:]

        folded: dict = {}

        def rank_of(k):
            if k not in folded:
                shj = mat.transpose_column(mat.sum_columns(Ch[k], True), True)
                folded[k] = ev.add(mat.sum_rows(Cv[k]), mat.replicate_row(shj))
            return folded[k]

        comp = Comparison(ev)
        acc = [None] * B
        for j, k in self.combos:
            s = rank_of(k)
            subm = np.repeat(-(j * sub + np.arange(sub, dtype=np.float64)) - 0.5, sub)
            rm = ev.add(s, ev.make_plaintext(subm, s.level, s.sdeg, slots=sub * sub))
            placed = ev.mult(comp.indicator_adv(rm, float(B * sub), dg_i, df_i), ladder(k)[0])
            acc[j] = placed if acc[j] is None else ev.add(acc[j], placed)
        acc = all_reduce_mod(ev, acc, self.mesh, "batch")
        return [mat.transpose_column(mat.sum_columns(a, True), True) for a in acc]
