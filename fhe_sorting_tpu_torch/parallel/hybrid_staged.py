"""Staged hybrid DirectSort: the reference's maxArraySize=256 tiling at N > 256.

Port of `fhe_sorting_tpu/parallel/hybrid_staged.py`.  The reference's hybrid
placement (sort_algo.h:893-1047) lays ranks out N x N-matrix style: for
N > 256 it tiles into batches of 256 (num_slots = ring/2, num_batch =
N/256), indicates each row's target with a sign-based indicator
(CompositeSign<3>, dg 4 or 5; the sinc branch is for N < 256), and places
elements through the sumColumnsToTarget / transposeColumnTarget binary-path
folds (sort_algo.h:824-891).

construct_rank is `StagedDirectSort`'s; the placement runs as named
stages (graphs on a CUDA context unless `graphs=False`) through the same
runner and stage table: the rank prep and rotations, per (b, k) the
indicator's sign iterations over both branches and the combine, per b the
binary-path folds in segments, and the final sum.  A stage whose closure
bakes in a host value (a batch's offset, mask or ladder) is named per batch.
The sort's key set is `hybrid_rotation_indices`: constructRank's scan keys
and the placement's basis, held together (16 rotation keys and relin at
N=512, ring 2^17: 19.9 GiB at depth 48, dnum 5).  Given once, they serve
every sort, so a second sort on one evaluator replays every stage's graph
and captures none.  While `core/trace.py` records, the placement is the
span `hybrid.rotation_index_check` over its stages' dispatch spans
(`hybrid.Hprep`, ..., `hybrid.Hfin`).
"""

from __future__ import annotations

import numpy as np

from ..core import trace
from ..core.cipher import Ciphertext
from ..models.direct_sort import DirectSort
from ..ops.rotation import RotationComposer
from ..ops.sign import F3, G3, SignConfig, eval_odd_poly7
from .direct_staged import StagedDirectSort, scan_rotation_indices


def hybrid_staged_keys(N: int, ring_n: int, max_array: int = 256) -> set:
    """Placement-phase key basis: {±1, -max_array} + powers of four + batch
    offsets.

    Every placement step (sumColumnsToTarget's halving ladder,
    transposeColumnTarget's s(s-1)/2 >> i ladder, the -1/-255-style
    fixups) decomposes over this basis in at most 13 hops, and each hop runs
    at end-of-chain levels; the basis is chosen for memory (9 keys at N=512,
    ring 2^17), not for the number of hops.  -max_array is keyed because the
    transpose fixup of every batch b >= 1 needs rotate(-(size-1))."""
    nh = ring_n // 2
    num_batch = max(1, N // max_array)
    ks = {1, -1, -max_array}
    for b in range(1, num_batch):
        ks.add((b * max_array) % nh)
    p = 4
    while p < nh:
        ks.add(p)
        p *= 4
    ks.discard(0)
    return ks


def hybrid_rotation_indices(N: int, ring_n: int, max_array: int = 256) -> set:
    """The hybrid sort's whole key set: constructRank's scan keys and the
    placement's basis (16 steps at N=512, ring 2^17)."""
    return scan_rotation_indices(N, ring_n) | hybrid_staged_keys(N, ring_n, max_array)


class StagedHybridSort:
    """sort_hybrid (sort_algo.h:1050-1064) with the true 256-wide tiling."""

    def __init__(self, ev, N: int, sign_cfg: SignConfig, max_array: int = 256,
                 indicator_dg: int | None = None, graphs: bool | None = None):
        self.ev = ev
        self.N = N
        self.max_array = max_array
        ring = ev.ctx.params.ring_n
        self.num_slots = ring // 2 if N > max_array else N * N
        self.num_batch = max(1, N // max_array)
        self.size = min(N, max_array)
        assert self.num_slots <= ring // 2
        self.base = StagedDirectSort(ev, N, sign_cfg, graphs)
        self.base.stages.prefix = "hybrid"
        self.rot = RotationComposer(ev, sorted(hybrid_staged_keys(N, ring, max_array)))
        self.srt = DirectSort(ev, N, rot=self.rot)
        # sort_algo.h:968-981: dg 4 below N=512, else 5
        self.dgi = indicator_dg or (4 if N < 512 else 5)
        # one stage table for both phases: the placement's stages run and are
        # counted by constructRank's runner, their spans named `hybrid.<stage>`
        self.stages = self.base.stages
        self._run = self.base._run

    def _ind_coeff_plan(self):
        """Per-iteration coefficients of the placement indicator's two
        CompositeSign<3> branches (dg = self.dgi, df = 2), the final 0.5
        folded into the last."""
        plan = [(G3, f"g{i}") for i in range(self.dgi)]
        plan += [(F3, f"f{i}") for i in range(2)]
        cs, tag = plan[-1]
        plan[-1] = (tuple(c * 0.5 for c in cs), tag + "s")
        return plan

    def place(self, rank: Ciphertext, ct: Ciphertext) -> Ciphertext:
        """rotationIndexCheckHybrid (sort_algo.h:893-1047), staged: one stage
        per sign iteration over both indicator branches."""
        with trace.span("hybrid.rotation_index_check", self.ev.ctx.device):
            return self._place(rank, ct)

    def _place(self, rank: Ciphertext, ct: Ciphertext) -> Ciphertext:
        ev, N = self.ev, self.N
        num_slots, num_batch, size = self.num_slots, self.num_batch, self.size
        stretch = 1.0 + 8.0 / N
        c_ind = 0.5 / (N * stretch)

        def stage_prep(cts):
            r = cts[0]
            if r.sdeg == 2:
                r = ev.rescale(r)
            r = r.set_slots(num_slots)
            return ev.mult(r, 1.0 / (N * stretch))

        r = self._run("Hprep", stage_prep, [rank])

        def stage_rot(cts, b):
            return [self.rot.rotate(cts[0], b * self.max_array),
                    self.rot.rotate(cts[1].set_slots(num_slots), b * self.max_array)]

        rots = [self._run(f"Hrot{b}", lambda cts, b=b: stage_rot(cts, b), [r, ct])
                for b in range(num_batch)]
        rots_rank = [x[0] for x in rots]
        rots_inp = [x[1] for x in rots]

        plan = self._ind_coeff_plan()

        def stage_iter(cts, cs):
            return [eval_odd_poly7(ev, cts[0], cs), eval_odd_poly7(ev, cts[1], cs)]

        def stage_comb(cts):
            y1, y2, inp = cts
            # c1*(1-c2) with c = 0.5*s + 0.5 (the 0.5 folded into the last
            # iteration): (y1+0.5)*(0.5-y2)
            ind = ev.mult(ev.add(y1, 0.5), ev.rsub(0.5, y2))
            return ev.mult(inp, ind)

        # binary-path folds (sum_columns_to_target / transpose_column_target,
        # sort_algo.h:824-891) as segmented rotate-add stages
        def seg(cts, steps, mask=None):
            c = cts[0].set_slots(size * size)
            for extra in cts[1:]:
                c = ev.add(c, extra.set_slots(size * size))
            for s in steps:
                c = ev.add(c, self.rot.rotate(c, s))
            if mask is not None:
                c = ev.mult_plain_at(c, mask)
            return c

        def ladder(initial_step, path):
            steps = []
            st = initial_step
            for bit in path:
                steps.append(-st if bit else st)
                st >>= 1
            return steps

        masked = []
        for b in range(num_batch):
            sub_mask = np.zeros(num_slots)
            for i in range(size):
                sub_mask[i * size : (i + 1) * size] = (b * size + i) / (N * stretch)

            def stage_sub(cts, sub_mask=sub_mask):
                sub_pt = ev.make_plaintext(sub_mask, cts[0].level, cts[0].sdeg, slots=num_slots)
                rm = ev.rsub(sub_pt, cts[0])
                return [ev.add(rm, c_ind), ev.sub(rm, c_ind)]

            terms = []
            for k in range(num_batch):
                ys = self._run(f"Hsub{b}", stage_sub, [rots_rank[k]])
                for cs, tag in plan:
                    ys = self._run(f"HB{tag}", lambda cts, cs=cs: stage_iter(cts, cs), ys)
                terms.append(self._run("Hcomb", stage_comb, [ys[0], ys[1], rots_inp[k]]))

            path = self.srt._binary_path(b, size)
            sum_steps = ladder(size >> 1, path)
            m_col = np.zeros(size * size)
            m_col[b::size] = 1.0
            tr_steps = ladder(size * (size - 1) // 2, path)
            m_row = np.zeros(size * size)
            m_row[size * b : size * (b + 1)] = 1.0

            acc = self._run(f"HplaceS{b}", lambda cts, ss=sum_steps, mc=m_col: seg(cts, ss, mc),
                            terms)
            # the transpose ladder in three segments; its first steps take
            # the most hops
            cut = max(1, len(tr_steps) // 3)
            acc = self._run(f"HplaceT{b}a", lambda cts, ss=tr_steps[:cut]: seg(cts, ss), [acc])
            acc = self._run(f"HplaceT{b}b", lambda cts, ss=tr_steps[cut:2 * cut]: seg(cts, ss),
                            [acc])
            masked.append(self._run(
                f"HplaceT{b}c", lambda cts, ss=tr_steps[2 * cut:], mr=m_row: seg(cts, ss, mr),
                [acc]))

        return self._run("Hfin", lambda cts: ev.add_many(cts), masked)

    def __call__(self, ct: Ciphertext) -> Ciphertext:
        return self.place(self.base.construct_rank(ct), ct)
