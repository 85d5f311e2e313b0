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

The JAX package compiles a rank's program into one jitted SPMD step with
two merge points.  Here it runs as named stages of a `StageTable`
(`parallel/whole_graph.py`): on a CUDA context each stage is a captured CUDA
graph, replayed at every later call, and on the CPU (or with
`graphs=False`) an eager call:

  rank   ladder  a part's replicate-row and transpose-replicate-column ladders
         cmp     a pair's signAdv comparison; flip, its transpose 1 - C
         acc     the running Cv / Ch sums
  place  fold    a part's rank: the Cv row sums beside the folded Ch
         place   a combo's index offset (the plaintext of its output part,
                 an input), indicator and placement
         acc2    the running sums by output part
         out     an output part's column sum and transpose

The two all-reduces run between the stages, on the caller's stream; the
ranks' agreement on the summed metadata is checked once per sort object
(`mesh.check_agreement`), when its stages are first built.  Every rank
needs at least one pair and one combo.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from ..models.mehp24.sort import Mehp24Sort
from ..ops.compare import Comparison
from ..ops.sign import sign_adv
from .mesh import all_reduce_mod, batch_sharding, check_agreement, make_mesh
from .whole_graph import StageTable

# the stages of each phase, for `phase_stats`
RANK_STAGES = ("ladder", "cmp", "flip", "acc")


class ShardedMehp24:
    """The multi-ciphertext sortFG with its triangle split over the mesh, its
    rank's program as named stages (the module docstring).  `graphs=None`
    runs the stages on CUDA graphs on a CUDA context and eagerly on the CPU;
    `graphs=False` runs them eagerly on the card too."""

    def __init__(self, ev, sub_length: int, num_parts: int, dg_c: int = 1, df_c: int = 1,
                 dg_i: int = 1, df_i: int = 1, mesh=None, graphs: bool | None = None):
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
        self.stages = StageTable(ev, graphs, "mehp24_sharded")
        self._agreed: set = set()

    def _run(self, name: str, fn, cts):
        return self.stages.run(name, fn, cts)

    def stage_stats(self) -> Counter:
        """Evaluator ops of every stage call so far: each stage's
        per-dispatch tally times its calls."""
        return self.stages.tally()

    @staticmethod
    def phase_of(stage: str) -> str:
        """The phase a stage belongs to: the comparisons up to the Cv/Ch
        sums ("rank") or the placement ("place")."""
        return "rank" if stage in RANK_STAGES else "place"

    def phase_stats(self) -> dict:
        """`stage_stats` split by phase (`phase_of`)."""
        out = {"rank": Counter(), "place": Counter()}
        for name, st in self.stages.items():
            out[self.phase_of(name)] += st.tally()
        return out

    def _all_reduce(self, point: str, cts: list) -> list:
        """The ranks' partial sums at each position, all-reduced over the
        batch axis; their agreement on the metadata is checked at the first
        sort."""
        if point not in self._agreed:
            check_agreement(cts, self.mesh, "batch")
            self._agreed.add(point)
        return all_reduce_mod(self.ev, cts, self.mesh, "batch")

    def __call__(self, parts):
        """parts: B ciphertexts with the same metadata; returns the B sorted
        parts."""
        ev, mat, B, sub = self.ev, self.srt.mat, self.B, self.sub
        dg_c, df_c, dg_i, df_i = self.cfg
        ladders: dict = {}

        def ladder(k):
            if k not in ladders:
                ladders[k] = self._run("ladder", lambda cts: [
                    mat.replicate_row(cts[0]),
                    mat.replicate_column(mat.transpose_row(cts[0], True))], [parts[k]])
            return ladders[k]

        def acc(name, total, term):
            return term if total is None else self._run(name, lambda cts: ev.add(*cts),
                                                        [total, term])

        Cv, Ch = [None] * B, [None] * B
        for j, k in self.pairs:
            cjk = self._run("cmp", lambda cts: sign_adv(ev, ev.sub(*cts), dg_c, df_c),
                            [ladder(j)[0], ladder(k)[1]])
            Cv[j] = acc("acc", Cv[j], cjk)
            if j != k:
                Ch[k] = acc("acc", Ch[k], self._run("flip", lambda cts: ev.rsub(1.0, cts[0]),
                                                    [cjk]))
        # Cv at every position, Ch beside it (Ch[0] is all zeros)
        sums = self._all_reduce("rank", Cv + Ch)
        Cv, Ch = sums[:B], sums[B:]

        def stage_fold(cts):
            cv, ch = cts
            shj = mat.transpose_column(mat.sum_columns(ch, True), True)
            return ev.add(mat.sum_rows(cv), mat.replicate_row(shj))

        comp = Comparison(ev)

        def stage_place(cts):
            s, offset, row = cts
            return ev.mult(comp.indicator_adv(ev.add(s, offset), float(B * sub), dg_i, df_i), row)

        folded: dict = {}
        out = [None] * B
        for j, k in self.combos:
            if k not in folded:
                folded[k] = self._run("fold", stage_fold, [Cv[k], Ch[k]])
            s = folded[k]
            subm = np.repeat(-(j * sub + np.arange(sub, dtype=np.float64)) - 0.5, sub)
            offset = ev.make_plaintext(subm, s.level, s.sdeg, slots=sub * sub)
            out[j] = acc("acc2", out[j], self._run("place", stage_place,
                                                   [s, offset, ladder(k)[0]]))
        out = self._all_reduce("place", out)
        return [self._run("out", lambda cts: mat.transpose_column(
            mat.sum_columns(cts[0], True), True), [a]) for a in out]
