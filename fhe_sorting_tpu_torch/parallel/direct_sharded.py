"""Multi-device DirectSort: the num_batch loops as a sharded mesh axis.

Port of `fhe_sorting_tpu/parallel/direct_sharded.py`.  The reference runs
constructRank's and rotationIndexCheck's per-batch work as OpenMP loops over
num_batch (`sort_algo.h:438-492` and `713-742`).  Here each rank of the
mesh's "batch" axis loops over its own contiguous block of batches, and the
cross-batch sums are all-reduces over the axis (`mesh.all_reduce_mod`),
bit-equal to the JAX package's chain of modular adds.  The refactoring that
makes every batch run the same program is the JAX package's:

    rot(x, b*P + j*np) = rot(rot(x, j*np), b*P)

so every batch uses the giant-step keys and masks of batch 0, and only the
"batch offset" rotation by b*P differs, each with a key of its own
(`gen_offset_keys`, the key of offset 0 a key switch to s itself).  The
distinct-key count drops from O(num_batch * P/np) to O(P/np + num_batch),
which is what makes N=1024 fit one card.  As in the JAX package, each rank
holds only the offset keys of its own batches.

Phase structure (sort_algo.h:368-506, 658-750):
  1. each rank rotates the input by each of its batches' offsets, builds the
     baby steps and the batch-0-shaped vecRots and compares -> partial
     ranks; all-reduce over the batch axis, then the log-tree fold
     (replicated) -> rank;
  2. each rank evaluates the doubled-sinc Chebyshev indicator of
     (index - rank - check_b)/2N for its batches, blind-rotates with the
     shared giants and applies the batch-offset rotation; the outputs
     all-reduce and fold into the sorted ciphertext, replicated.

The JAX package compiles a rank's program into one jitted SPMD step.  Here
it runs as named stages of a `StageTable` (`parallel/whole_graph.py`): on
a CUDA context each stage is a captured CUDA graph, replayed at every later
call, and on the CPU (or with `graphs=False`) an eager call:

  constructRank       R_off{b}  batch b's offset rotation (its key baked in)
                      R_cmp     babies, vecRots, compare (shared by batches)
                      R_acc     the rank's running sum of its batches
                      R_fold    log-tree fold + SetSlots - 0.5
  rotationIndexCheck  P_imr     index minus rank, in the Chebyshev domain
                      P_place   checking vector (an input: the JAX step's
                                sharded argument), PS sinc, mask product,
                                blind rotation (shared by batches)
                      P_off{b}  batch b's offset rotation
                      P_acc     the rank's running sum
                      P_fold    log-tree fold + SetSlots

The two all-reduces run between the stages, on the caller's stream; the
ranks' agreement on the summed metadata is checked once per sort object
(`mesh.check_agreement`), when its stages are first built.

On a ("batch", "limb") mesh pass a `LimbParallelEvaluator` whose keys hold
the rank's rows (`Keys.rows`): the input is split over the limb axis on the
way in and gathered on the way out, each rank computes its own rows of
every op, and the key switches' gathers and the rescales' broadcasts run
inside the stages (captured with them under NCCL; under gloo the stages run
eagerly, `graphs=False`).  The offset keys are made from the evaluator's
key set, so a limb rank makes and holds only its rows of them too.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np

from ..core.cipher import Ciphertext
from ..models.direct_sort import DirectSort, _default_np, checking_vector_n, index_vector
from ..ops.sign import SignConfig, SignFunc
from ..utils.sinc_coeffs import doubled_sinc_coefficients
from .limb_parallel import LimbParallelEvaluator
from .mesh import all_reduce_mod, batch_sharding, check_agreement, make_mesh
from .whole_graph import StageTable


def rotation_indices_sharded(N: int, ring_n: int) -> set:
    """Keys the sharded formulation needs: babies, batch-independent giants,
    folds.  Batch offsets (b*P, including 0) come from `gen_offset_keys`,
    because offset 0 needs the identity-galois key."""
    max_batch = ring_n // 2
    P = min(N, max_batch // N)
    num_slots = N * P
    np_ = min(_default_np(P, N), P)
    idx = set()
    idx.update(range(1, np_))                    # babies / pre-rotations
    idx.update(j * np_ for j in range(1, P // np_))
    idx.update(i * np_ for i in range(1, (num_slots // N) // np_))
    for i in range(1, int(math.log2(P)) + 1):
        idx.add(num_slots >> i)                  # folds
    idx.discard(0)
    return idx


def gen_offset_keys(keys, offsets, keep=None) -> list:
    """Rotation keys for the batch offsets, in order, from one stream
    (`default_rng(11)`) and INCLUDING rotation 0, the identity galois
    element g=1 (a key switch to s itself: every batch applies an offset
    rotation, batch 0 too, so all run one program).  A key already held is
    returned as it is.

    `keep` (indices into `offsets`; all by default) are the keys this rank
    holds; the others' entries are None, and no key of theirs is made.  A
    key set that holds a limb rank's rows (`Keys.rows`) makes only those.  The
    i-th key is the stream's i-th draw, whether it is made, held already or
    skipped (`Keys._ksk_draws`), so every world size computes with the same
    keys."""
    keep = set(range(len(offsets)) if keep is None else keep)
    gs = [keys.ctx.galois_element_rot(r) for r in offsets]
    # the stream is drawn as far as the last kept key still to make
    last = max((i for i in keep if gs[i] not in keys.rot), default=-1)
    rng = np.random.default_rng(11)
    for i, g in enumerate(gs[:last + 1]):
        if i in keep and g not in keys.rot:
            # galois_perm(1) is the identity: the target is s itself
            keys.rot[g] = keys._gen_ksk(keys._s_dev[:, keys.ctx.galois_perm(g)], rng)
        else:
            keys._ksk_draws(rng)
    return [keys.rot[g] if i in keep else None for i, g in enumerate(gs)]


class ShardedDirectSort:
    """DirectSort with its batches sharded over the mesh's "batch" axis, its
    rank's program as named stages (the module docstring).

    Each rank holds the offset keys of its own batches only
    (`gen_offset_keys`).  Every rank needs at least one batch.  `graphs=None`
    runs the stages on CUDA graphs on a CUDA context and eagerly on the CPU;
    `graphs=False` runs them eagerly on the card too."""

    def __init__(self, ev, N: int, sign_cfg: SignConfig, mesh=None,
                 graphs: bool | None = None):
        self.ev = ev
        self.N = N
        self.cfg = sign_cfg
        ring = ev.ctx.params.ring_n
        self.P = min(N, (ring // 2) // N)
        self.nb = N // self.P
        self.num_slots = N * self.P
        self.np_ = min(_default_np(self.P, N), self.P)
        self.mesh = mesh or make_mesh()
        self.batches = batch_sharding(self.mesh, self.nb)
        assert len(self.batches) > 0, f"{self.nb} batches leave this rank none"
        self.srt = DirectSort(ev, N)     # mask generators, composer, compare, PS
        self.off_keys = gen_offset_keys(ev.keys, [b * self.P for b in range(self.nb)],
                                        keep=self.batches)
        stretch = 1.0 + 4.0 / N
        self.alpha = 1.0 / (2.0 * N * stretch)
        self.coeffs = doubled_sinc_coefficients(N, stretch=stretch)
        self.stages = StageTable(ev, graphs, "direct_sharded")
        self._agreed: set = set()

    # -- stage infrastructure ---------------------------------------------

    def _run(self, name: str, fn, cts):
        return self.stages.run(name, fn, cts)

    def stage_stats(self) -> Counter:
        """Evaluator ops of every stage call so far: each stage's
        per-dispatch tally times its calls."""
        return self.stages.tally()

    @staticmethod
    def phase_of(stage: str) -> str:
        """The phase a stage belongs to: constructRank (the R_ stages) or
        rotationIndexCheck (the P_ stages)."""
        return "constructRank" if stage.startswith("R_") else "rotationIndexCheck"

    def phase_stats(self) -> dict:
        """`stage_stats` split by phase (`phase_of`), for the per-phase
        roofline."""
        out = {"constructRank": Counter(), "rotationIndexCheck": Counter()}
        for name, st in self.stages.items():
            out[self.phase_of(name)] += st.tally()
        return out

    def _batch_sum(self, point: str, local: Ciphertext) -> Ciphertext:
        """This rank's sum of its batches, all-reduced over the batch axis;
        the ranks' agreement on its metadata is checked at the first sort."""
        if point not in self._agreed:
            check_agreement([local], self.mesh, "batch")
            self._agreed.add(point)
        return all_reduce_mod(self.ev, [local], self.mesh, "batch")[0]

    def _fold(self, ct: Ciphertext) -> Ciphertext:
        for i in range(1, int(math.log2(self.P)) + 1):
            ct = self.ev.add(ct, self.srt.rot.rotate(ct, self.num_slots >> i))
        return ct.set_slots(self.N)

    def _offset(self, x: Ciphertext, b: int) -> Ciphertext:
        """Batch b's offset rotation, with its own key."""
        return self.ev.rotate_with_key(x, b * self.P, self.off_keys[b])

    def _masked_sum(self, u: Ciphertext) -> Ciphertext:
        """The masked-rotation sum of an offset-rotated input: its baby steps
        and the batch-0-shaped vecRots over them (`DirectSort._vec_rots_opt`
        at batch 0)."""
        srt = self.srt
        babies = [u if i == 0 else srt.rot.rotate(u, i) for i in range(self.np_)]
        return srt._vec_rots_opt(babies, self.P, self.num_slots, self.np_, 0)

    # -- phase 1: constructRank -------------------------------------------

    def construct_rank(self, inp: Ciphertext) -> Ciphertext:
        """The replicated rank of `inp` (at num_slots slots)."""
        ev, srt = self.ev, self.srt

        def stage_cmp(cts):
            u, x = cts
            return srt.comp.compare(x, self._masked_sum(u), SignFunc.CompositeSign, self.cfg)

        local = None
        for b in self.batches:
            u = self._run(f"R_off{b}", lambda cts, b=b: self._offset(cts[0], b), [inp])
            c = self._run("R_cmp", stage_cmp, [u, inp])
            local = c if local is None else self._run("R_acc", lambda cts: ev.add(*cts), [local, c])
        return self._run("R_fold", lambda cts: ev.sub(self._fold(cts[0]), 0.5),
                         [self._batch_sum("rank", local)])

    # -- phase 2: rotationIndexCheckN -------------------------------------

    def index_check(self, rank: Ciphertext, inp: Ciphertext) -> Ciphertext:
        """Each element of `inp` placed at its rank: the sorted ciphertext,
        replicated."""
        ev, srt = self.ev, self.srt

        def stage_imr(cts):
            r = cts[0]
            if r.sdeg == 2:
                r = ev.rescale(r)
            idx_pt = ev.make_plaintext(index_vector(self.N), r.level, r.sdeg, slots=self.N)
            imr = ev.mult(ev.rsub(idx_pt, r).set_slots(self.num_slots), self.alpha)
            return ev.rescale(imr) if imr.sdeg == 2 else imr

        def stage_place(cts):
            imr, check, x = cts
            masked = ev.mult(srt.ps.evaluate(ev.sub(imr, check), self.coeffs), x)
            mrots = [masked]
            if self.np_ > 1:
                pre = ev.rotate_precompute(masked)
                mrots += [srt.rot.rotate_hoisted(masked, pre, i) for i in range(1, self.np_)]
            return srt._blind_rotation_opt_n(mrots, self.num_slots, self.np_, 0, self.P)

        imr = self._run("P_imr", stage_imr, [rank])
        local = None
        for b in self.batches:
            check = ev.make_plaintext(checking_vector_n(self.N, self.num_slots, b * self.P)
                                      * self.alpha, imr.level, imr.sdeg, slots=self.num_slots)
            inner = self._run("P_place", stage_place, [imr, check, inp])
            placed = self._run(f"P_off{b}", lambda cts, b=b: self._offset(cts[0], b), [inner])
            local = placed if local is None else self._run("P_acc", lambda cts: ev.add(*cts),
                                                           [local, placed])
        return self._run("P_fold", lambda cts: self._fold(cts[0]), [self._batch_sum("out", local)])

    def __call__(self, ct: Ciphertext) -> Ciphertext:
        ev = self.ev
        limb_parallel = isinstance(ev, LimbParallelEvaluator)
        if limb_parallel:
            ct = ev.ingest(ct)
        # slots=N encoded; the program reads it at num_slots (SetSlots
        # sparse packing, sort_algo.h:429-434)
        inp = ct.set_slots(self.num_slots)
        out = self.index_check(self.construct_rank(inp), inp)
        return ev.gather(out) if limb_parallel else out
