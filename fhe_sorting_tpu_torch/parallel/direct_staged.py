"""DirectSort as a sequence of named stages over the minimal key set.

Port of `fhe_sorting_tpu/parallel/direct_staged.py`.  The stages are the
reference's; each is a `WholeGraph` (`parallel/whole_graph.py`), the
counterpart of the reference's `WholeJit`: on a CUDA context a captured
CUDA graph, replayed at every later call, and on the CPU (or with
`graphs=False`) an eager call:

  phase 1, per batch:  A  babies + giant-step Horner -> diff = dup - shifted
                       B* one stage per composite-sign iteration
                       C  compare affine + rank accumulate
           once:       D  log-tree fold + SetSlots + (-0.5)
  phase 2, once:       E  index-minus-rank prep (Chebyshev domain scale)
           per batch:  Esub, FG  checking vector, PS Chebyshev sinc
                       H  mask-mult + pre-rotations + blind-rotation Horner
           once:       I  batch Horner recombine + fold + SetSlots

`stages[name]` counts the stage's calls (`calls`) and holds the evaluator
ops one call issues (`op_counts`); `stage_stats` and `phase_stats` weight
them by the calls for the roofline (`utils/roofline.accumulate_sol`).
While `core/trace.py` records, each phase is a span
(`direct.construct_rank`, `direct.index_check`) over its stages' dispatch
spans (`direct.A`, `direct.Bg0`, ..., `direct.FG`, ...).  Key set:
`scan_rotation_indices`.
"""

from __future__ import annotations

import math
from collections import Counter

from ..core import trace
from ..core.cipher import Ciphertext
from ..models.direct_sort import _default_np, checking_vector_n, index_vector, mask_block
from ..ops.chebyshev import ChebyshevPS
from ..ops.sign import F3, G3, SignConfig, eval_odd_poly7
from ..utils.sinc_coeffs import doubled_sinc_coefficients
from .whole_graph import StageTable


def scan_rotation_indices(N: int, ring_n: int) -> set:
    """Minimal key set: {1, np, P} + the fold steps.  Babies are rot-by-1
    chains, giant steps Horner chains of rot-by-np, batch offsets rot-by-P,
    so only the power-of-two folds need keys of their own."""
    P = min(N, (ring_n // 2) // N)
    num_slots = N * P
    idx = {1, min(_default_np(P, N), P)}
    if N // P > 1:
        idx.add(P)
    idx.update(num_slots >> i for i in range(1, int(math.log2(P)) + 1))
    idx.discard(0)
    return idx


class StagedDirectSort:
    """DirectSort over the minimal key set, one graph (or eager call) per
    stage.  `graphs=None` runs on graphs on a CUDA context and eagerly on the
    CPU; `graphs=False` runs eagerly on the card too."""

    def __init__(self, ev, N: int, sign_cfg: SignConfig, graphs: bool | None = None):
        assert sign_cfg.compos.n == 3, "staged path implements CompositeSign<3>"
        self.ev = ev
        self.N = N
        self.cfg = sign_cfg
        ring = ev.ctx.params.ring_n
        self.P = min(N, (ring // 2) // N)
        self.nb = N // self.P
        self.num_slots = N * self.P
        self.np_ = min(_default_np(self.P, N), self.P)
        self.J = self.P // self.np_
        self.I2 = (self.num_slots // N) // self.np_
        self.ps = ChebyshevPS(ev)
        stretch = 1.0 + 4.0 / N
        self.alpha = 1.0 / (2.0 * N * stretch)
        self.coeffs = doubled_sinc_coefficients(N, stretch=stretch)
        self.stages = StageTable(ev, graphs, "direct")

    # -- stage infrastructure ---------------------------------------------

    def _run(self, name: str, fn, cts):
        return self.stages.run(name, fn, cts)

    def stage_stats(self) -> Counter:
        """Evaluator ops of every stage call so far: each stage's
        per-dispatch tally times its calls, as the reference sums them."""
        return self.stages.tally()

    def phase_stats(self) -> dict:
        """`stage_stats` split into constructRank (stages A-D) and
        rotationIndexCheck (E-I), for the per-phase roofline."""
        out = {"constructRank": Counter(), "rotationIndexCheck": Counter()}
        for name, st in self.stages.items():
            out["constructRank" if name[0] in "ABCD" else "rotationIndexCheck"] += st.tally()
        return out

    def one_sort_stats(self) -> dict:
        """`phase_stats` of one sort: every sort so far issued the same ops,
        and stage D runs once a sort (a warm-up and its capture included)."""
        sorts = self.stages["D"].calls
        return {ph: Counter({k: v // sorts for k, v in st.items()})
                for ph, st in self.phase_stats().items()}

    # -- phase 1: constructRank -------------------------------------------

    def _sign_coeff_plan(self):
        """[(coeffs, tag)] for the dg x g3 + df x f3 iterations, with the
        compare post-scale 0.5 folded into the last iteration."""
        dg, df = self.cfg.compos.dg, self.cfg.compos.df
        plan = [(G3, f"g{i}") for i in range(dg)] + [(F3, f"f{i}") for i in range(df)]
        cs, tag = plan[-1]
        plan[-1] = (tuple(c * 0.5 for c in cs), tag + "s")
        return plan

    def construct_rank(self, ct: Ciphertext) -> Ciphertext:
        with trace.span("direct.construct_rank", self.ev.ctx.device):
            return self._construct_rank(ct)

    def _construct_rank(self, ct: Ciphertext) -> Ciphertext:
        ev = self.ev
        N, np_, J, P = self.N, self.np_, self.J, self.P
        num_slots = self.num_slots
        base = mask_block(num_slots, 0, N)

        def stage_a(cts):
            u, dup = cts
            babies = [u]
            for _ in range(1, np_):
                babies.append(ev.rotate(babies[-1], 1))
            babies = [b.set_slots(num_slots) for b in babies]
            shifted = None
            for j in range(J - 1, -1, -1):
                T = None
                for i in range(np_):
                    r = (np_ * j + i) * N + j * np_
                    term = ev.mult_plain_at(babies[i], base, roll=r)
                    T = term if T is None else ev.add(T, term)
                shifted = T if shifted is None else ev.add(T, ev.rotate(shifted, np_))
            diff = ev.sub(dup.set_slots(num_slots), shifted)
            nxt = ev.rotate(u, P) if self.nb > 1 else u
            return [diff, nxt]

        rank = None
        u = ct
        for _ in range(self.nb):
            y, u = self._run("A", stage_a, [u, ct])
            for cs, tag in self._sign_coeff_plan():
                y = self._run(f"B{tag}", lambda cts, cs=cs: eval_odd_poly7(ev, cts[0], cs), [y])
            # compare = 0.5*sign + 0.5 (the 0.5 scale is folded into B)
            if rank is None:
                rank = self._run("C0", lambda cts: ev.add(cts[0], 0.5), [y])
            else:
                rank = self._run("C", lambda cts: ev.add(cts[0], ev.add(cts[1], 0.5)),
                                 [y, rank])

        def stage_d(cts):
            r = cts[0]
            for i in range(1, int(math.log2(P)) + 1):
                r = ev.add(r, ev.rotate(r, num_slots >> i))
            return ev.sub(r.set_slots(N), 0.5)

        return self._run("D", stage_d, [rank])

    # -- phase 2: rotationIndexCheckN -------------------------------------

    def index_check(self, rank: Ciphertext, ct: Ciphertext) -> Ciphertext:
        with trace.span("direct.index_check", self.ev.ctx.device):
            return self._index_check(rank, ct)

    def _index_check(self, rank: Ciphertext, ct: Ciphertext) -> Ciphertext:
        ev = self.ev
        N, np_, I2, P = self.N, self.np_, self.I2, self.P
        num_slots = self.num_slots
        base2 = mask_block(num_slots, 0, N)
        alpha = self.alpha

        def stage_e(cts):
            r = cts[0]
            if r.sdeg == 2:
                r = ev.rescale(r)
            idx_pt = ev.make_plaintext(index_vector(N), r.level, r.sdeg, slots=N)
            imr = ev.mult(ev.rsub(idx_pt, r).set_slots(num_slots), alpha)
            if imr.sdeg == 2:
                imr = ev.rescale(imr)
            return imr

        imr = self._run("E", stage_e, [rank])

        def stage_h(cts):
            ri, inp = cts
            masked = ev.mult(ri, inp.set_slots(num_slots))
            mrots = [masked]
            for _ in range(1, np_):
                mrots.append(ev.rotate(mrots[-1], 1))
            inner = None
            for i in range(I2 - 1, -1, -1):
                tmp = None
                for j in range(np_):
                    r = (np_ * i + j) * N - j
                    term = ev.mult_plain_at(mrots[j], base2, roll=r)
                    tmp = term if tmp is None else ev.add(tmp, term)
                inner = tmp if inner is None else ev.add(tmp, ev.rotate(inner, np_))
            return inner

        inners = []
        for b in range(self.nb):
            check = checking_vector_n(N, num_slots, b * P) * alpha

            def stage_sub(cts, check=check):
                x = cts[0]
                return ev.sub(x, ev.make_plaintext(check, x.level, x.sdeg, slots=num_slots))

            x = self._run(f"Esub{b}", stage_sub, [imr])
            sinc = self._run("FG", lambda cts: self.ps.evaluate(cts[0], self.coeffs), [x])
            inners.append(self._run("H", stage_h, [sinc, ct]))

        def stage_i(cts):
            out = cts[-1]
            for b in range(len(cts) - 2, -1, -1):
                out = ev.add(cts[b], ev.rotate(out, P))
            for i in range(1, int(math.log2(P)) + 1):
                out = ev.add(out, ev.rotate(out, num_slots >> i))
            return out.set_slots(N)

        return self._run("I", stage_i, inners)

    def __call__(self, ct: Ciphertext) -> Ciphertext:
        return self.index_check(self.construct_rank(ct), ct)
