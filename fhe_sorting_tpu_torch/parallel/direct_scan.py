"""DirectSort with each phase as a few captured CUDA graphs, batches replayed.

Port of `fhe_sorting_tpu/parallel/direct_scan.py`.  The reference traces
each sort phase (constructRank, rotationIndexCheckN) as one XLA program
whose per-batch body, the same for every batch, compiles once and runs as a
`lax.scan` over the `num_batch` batches.  Here the body is one CUDA graph
(`WholeGraph`), captured once and replayed `nb` times:

  phase 1: the body takes the offset-rotated input u_b = rot(x, b*P) and
           the input, and gives u_{b+1} = rot(u_b, P) and the batch's
           comparison; u rides in the body's input buffer from replay to
           replay, as in the scan's carry.  A second graph folds the
           stacked comparisons (a tree of modular additions, `_fold_stack`),
           log-folds the rank and subtracts the self-comparison's 0.5;
  phase 2: a head graph turns the rank into the Chebyshev-domain index
           difference; the body is replayed over the batches' checking
           plaintexts, each copied into its input before its replay, as the
           scan takes its `xs`; a tail graph recombines
           sum_b rot(inner_b, b*P) as a Horner chain with the one step-P
           key, then folds.

Batch offsets cost the one rotation key P (`scan_rotation_indices`).
`phase_stats` holds one sort's op tallies by phase, the body's times `nb`,
as the reference's `build()` records them.  On a CPU context (or with
`graphs=False`) the same bodies run eagerly.
"""

from __future__ import annotations

import math
from collections import Counter

import torch

from ..core.cipher import Ciphertext
from ..core.modmath import add_mod, sub_mod
from ..models.direct_sort import _default_np, checking_vector_n, index_vector, mask_block
from ..ops.chebyshev import ChebyshevPS
from ..ops.compare import Comparison
from ..ops.sign import SignConfig, SignFunc
from ..utils.sinc_coeffs import doubled_sinc_coefficients
from .direct_staged import scan_rotation_indices  # noqa: F401 (re-export)
from .whole_graph import GraphSet, WholeGraph, use_graphs


class ScanDirectSort:
    """DirectSort as per-phase graphs with a replayed per-batch body.

    Key set: `scan_rotation_indices(N, ring)`."""

    def __init__(self, ev, N: int, sign_cfg: SignConfig, graphs: bool | None = None):
        self.ev = ev
        self.N = N
        self.cfg = sign_cfg
        ring = ev.ctx.params.ring_n
        self.P = min(N, (ring // 2) // N)
        self.nb = N // self.P
        self.num_slots = N * self.P
        self.np_ = min(_default_np(self.P, N), self.P)
        self.comp = Comparison(ev)
        self.ps = ChebyshevPS(ev)
        stretch = 1.0 + 4.0 / N
        self.alpha = 1.0 / (2.0 * N * stretch)
        self.coeffs = doubled_sinc_coefficients(N, stretch=stretch)
        self.graphs = use_graphs(ev, graphs)
        gs = GraphSet(ev.ctx.device) if self.graphs else None
        self._graph = {name: WholeGraph(ev, fn, self.graphs, gs, f"scan.{name}")
                       for name, fn in (("p1_body", self._p1_body), ("p1_tail", self._p1_tail),
                                        ("p2_head", self._p2_head), ("p2_body", self._p2_body),
                                        ("p2_tail", self._p2_tail))}
        self._check_pts = None
        self.phase_stats = {"constructRank": Counter(), "rotationIndexCheck": Counter()}

    def graph_stats(self) -> dict:
        """Per graph: (dispatches, capture seconds)."""
        return {k: (g.calls, g.capture_s) for k, g in self._graph.items()}

    def _tally(self, phase: str, *names):
        """One sort's op tally of `phase`: its graphs' per-dispatch tallies,
        a body's times `nb`."""
        total = Counter()
        for name in names:
            k = self.nb if name.endswith("body") else 1
            total += Counter({op: v * k for op, v in self._graph[name].op_counts.items()})
        self.phase_stats[phase] = total

    # -- phase 1: constructRank -------------------------------------------

    def _p1_body(self, cts):
        ev, N, np_, P = self.ev, self.N, self.np_, self.P
        num_slots = self.num_slots
        u, inp = cts
        # incremental baby steps: a rot-by-1 chain
        babies = [u]
        for _ in range(1, np_):
            babies.append(ev.rotate(babies[-1], 1))
        babies = [b.set_slots(num_slots) for b in babies]
        base = mask_block(num_slots, 0, N)
        # Horner giant accumulation with the step-np key, j high -> low
        shifted = None
        for j in range(P // np_ - 1, -1, -1):
            T = None
            for i in range(np_):
                r = (np_ * j + i) * N + j * np_
                term = ev.mult_plain_at(babies[i], base, roll=r)
                T = term if T is None else ev.add(T, term)
            shifted = T if shifted is None else ev.add(T, ev.rotate(shifted, np_))
        c = self.comp.compare(inp.set_slots(num_slots), shifted, SignFunc.CompositeSign, self.cfg)
        # incremental batch offset: u <- rot(u, P) for the next batch
        return [ev.rotate(u, P) if self.nb > 1 else u, c]

    def _fold_stack(self, cts) -> Ciphertext:
        """Tree modular sum of the batches' comparisons (raw additions, as
        the reference's `_fold_stack`: they are not evaluator ops)."""
        p = self.ev.ctx.p_active(cts[0].level)
        stacked = torch.stack([c.data for c in cts])
        nb = stacked.shape[0]
        while nb > 1:
            half = nb // 2
            s = add_mod(stacked[:half], stacked[half:2 * half], p)
            rest = stacked[2 * half:]
            stacked = torch.cat([s, rest]) if rest.shape[0] else s
            nb = stacked.shape[0]
        return cts[0].with_data(stacked[0])

    def _p1_tail(self, cts):
        ev, num_slots = self.ev, self.num_slots
        rank = self._fold_stack(cts)
        for i in range(1, int(math.log2(self.P)) + 1):
            rank = ev.add(rank, ev.rotate(rank, num_slots >> i))
        return ev.sub(rank.set_slots(self.N), 0.5)

    def construct_rank(self, ct: Ciphertext) -> Ciphertext:
        u, cs = ct, []
        for _ in range(self.nb):
            u, c = self._graph["p1_body"]([u, ct])
            cs.append(c)
        rank = self._graph["p1_tail"](cs)
        self._tally("constructRank", "p1_body", "p1_tail")
        return rank

    # -- phase 2: rotationIndexCheckN -------------------------------------

    def _p2_head(self, cts):
        ev, N = self.ev, self.N
        rank = cts[0]
        if rank.sdeg == 2:
            rank = ev.rescale(rank)
        idx_pt = ev.make_plaintext(index_vector(N), rank.level, rank.sdeg, slots=N)
        imr = ev.mult(ev.rsub(idx_pt, rank).set_slots(self.num_slots), self.alpha)
        if imr.sdeg == 2:
            imr = ev.rescale(imr)
        return imr

    def _p2_body(self, cts):
        ev, N, np_ = self.ev, self.N, self.np_
        num_slots = self.num_slots
        imr, inp, check = cts
        # imr - check, a raw subtraction as the reference's `_sub_pt`
        ri = ev._on_c0(imr, lambda c0: sub_mod(c0, ev._pt_planes(check), ev.moduli(imr)))
        ri = self.ps.evaluate(ri, self.coeffs)
        masked = ev.mult(ri, inp.set_slots(num_slots))
        # incremental pre-rotations: a rot-by-1 chain
        mrots = [masked]
        for _ in range(1, np_):
            mrots.append(ev.rotate(mrots[-1], 1))
        base2 = mask_block(num_slots, 0, N)
        # Horner giant accumulation with the single step-np key
        inner = None
        for i in range((num_slots // N) // np_ - 1, -1, -1):
            tmp = None
            for j in range(np_):
                r = (np_ * i + j) * N - j
                term = ev.mult_plain_at(mrots[j], base2, roll=r)
                tmp = term if tmp is None else ev.add(tmp, term)
            inner = tmp if inner is None else ev.add(tmp, ev.rotate(inner, np_))
        return inner

    def _p2_tail(self, cts):
        ev, P, num_slots = self.ev, self.P, self.num_slots
        # Horner recombination of sum_b rot(inner_b, b*P): acc = inner_b +
        # rot(acc, P), b high -> low
        out = cts[-1]
        for b in range(len(cts) - 2, -1, -1):
            out = ev.add(cts[b], ev.rotate(out, P))
        for i in range(1, int(math.log2(P)) + 1):
            out = ev.add(out, ev.rotate(out, num_slots >> i))
        return out.set_slots(self.N)

    def index_check(self, rank: Ciphertext, ct: Ciphertext) -> Ciphertext:
        ev = self.ev
        imr = self._graph["p2_head"]([rank])
        if self._check_pts is None:
            # the batches' checking vectors, encoded once at imr's level
            self._check_pts = [
                ev.make_plaintext(checking_vector_n(self.N, self.num_slots, b * self.P) * self.alpha,
                                  imr.level, imr.sdeg, slots=self.num_slots)
                for b in range(self.nb)]
        inners = [self._graph["p2_body"]([imr, ct, pt]) for pt in self._check_pts]
        out = self._graph["p2_tail"](inners)
        self._tally("rotationIndexCheck", "p2_head", "p2_body", "p2_tail")
        return out

    def __call__(self, ct: Ciphertext) -> Ciphertext:
        return self.index_check(self.construct_rank(ct), ct)
