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
which is what makes N=1024 fit one card.

Phase structure (sort_algo.h:368-506, 658-750):
  1. each rank rotates the input by each of its batches' offsets, builds the
     baby steps and the batch-0-shaped vecRots and compares -> partial
     ranks; all-reduce over the batch axis, then the log-tree fold
     (replicated) -> rank;
  2. each rank evaluates the doubled-sinc Chebyshev indicator of
     (index - rank - check_b)/2N for its batches, blind-rotates with the
     shared giants and applies the batch-offset rotation; the outputs
     all-reduce and fold into the sorted ciphertext, replicated.

On a ("batch", "limb") mesh pass a `LimbParallelEvaluator`: the input is
sharded over the limb axis on the way in and gathered on the way out.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ..core.cipher import Ciphertext
from ..models.direct_sort import DirectSort, _default_np, checking_vector_n, index_vector
from ..ops.sign import SignConfig, SignFunc
from ..utils.sinc_coeffs import doubled_sinc_coefficients
from .limb_parallel import LimbParallelEvaluator
from .mesh import all_reduce_mod, batch_sharding, make_mesh


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


def gen_offset_keys(keys, offsets):
    """Rotation keys for the batch offsets, in order, from one stream
    (`default_rng(11)`) and INCLUDING rotation 0, the identity galois
    element g=1 (a key switch to s itself: every batch applies an offset
    rotation, batch 0 too, so all run one program).  A key already held is
    returned as it is."""
    rng = np.random.default_rng(11)
    out = []
    for r in offsets:
        g = keys.ctx.galois_element_rot(r)
        if g not in keys.rot:
            # galois_perm(1) is the identity: the target is s itself
            keys.rot[g] = keys._gen_ksk(keys._s_dev[:, keys.ctx.galois_perm(g)], rng)
        out.append(keys.rot[g])
    return out


class ShardedDirectSort:
    """DirectSort with its batches sharded over the mesh's "batch" axis.

    Every rank generates and holds all num_batch offset keys (one stream,
    so every world size computes with the same keys) and uses those of its
    own batches.  Every rank needs at least one batch."""

    def __init__(self, ev, N: int, sign_cfg: SignConfig, mesh=None):
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
        self.off_keys = gen_offset_keys(ev.keys, [b * self.P for b in range(self.nb)])
        stretch = 1.0 + 4.0 / N
        self.alpha = 1.0 / (2.0 * N * stretch)
        self.coeffs = doubled_sinc_coefficients(N, stretch=stretch)

    def _batch_sum(self, cts) -> Ciphertext:
        """This rank's batches summed as they come, then all-reduced over the
        batch axis."""
        local = functools.reduce(self.ev.add, cts)
        return all_reduce_mod(self.ev, [local], self.mesh, "batch")[0]

    def _fold(self, ct: Ciphertext) -> Ciphertext:
        for i in range(1, int(math.log2(self.P)) + 1):
            ct = self.ev.add(ct, self.srt.rot.rotate(ct, self.num_slots >> i))
        return ct.set_slots(self.N)

    def _shifted(self, inp: Ciphertext, b: int) -> Ciphertext:
        """Batch b's masked-rotation sum: the input rotated by the batch
        offset with its own key, its baby steps, and the batch-0-shaped
        vecRots over them (`DirectSort._vec_rots_opt` at batch 0)."""
        srt = self.srt
        u = self.ev.rotate_with_key(inp, b * self.P, self.off_keys[b])
        babies = [u if i == 0 else srt.rot.rotate(u, i) for i in range(self.np_)]
        return srt._vec_rots_opt(babies, self.P, self.num_slots, self.np_, 0)

    def _partial_rank(self, inp: Ciphertext, b: int) -> Ciphertext:
        """Phase 1 of batch b: its comparisons."""
        return self.srt.comp.compare(inp, self._shifted(inp, b), SignFunc.CompositeSign, self.cfg)

    def _placed(self, imr: Ciphertext, inp: Ciphertext, b: int) -> Ciphertext:
        """Phase 2 of batch b: its checking vector, the sinc, the blind
        rotation with batch 0's giants (`DirectSort._blind_rotation_opt_n`)
        and the offset rotation."""
        ev, srt = self.ev, self.srt
        check = checking_vector_n(self.N, self.num_slots, b * self.P) * self.alpha
        x = ev.sub(imr, ev.make_plaintext(check, imr.level, imr.sdeg, slots=self.num_slots))
        masked = ev.mult(srt.ps.evaluate(x, self.coeffs), inp)
        mrots = [masked]
        if self.np_ > 1:
            pre = ev.rotate_precompute(masked)
            mrots += [srt.rot.rotate_hoisted(masked, pre, i) for i in range(1, self.np_)]
        inner = srt._blind_rotation_opt_n(mrots, self.num_slots, self.np_, 0, self.P)
        return ev.rotate_with_key(inner, b * self.P, self.off_keys[b])

    def __call__(self, ct: Ciphertext) -> Ciphertext:
        ev = self.ev
        limb_parallel = isinstance(ev, LimbParallelEvaluator)
        if limb_parallel:
            ct = ev.ingest(ct)
        # slots=N encoded; the program reads it at num_slots (SetSlots
        # sparse packing, sort_algo.h:429-434)
        inp = ct.set_slots(self.num_slots)

        rank = self._fold(self._batch_sum(self._partial_rank(inp, b) for b in self.batches))
        rank = ev.sub(rank, 0.5)
        if rank.sdeg == 2:
            rank = ev.rescale(rank)
        idx_pt = ev.make_plaintext(index_vector(self.N), rank.level, rank.sdeg, slots=self.N)
        imr = ev.mult(ev.rsub(idx_pt, rank).set_slots(self.num_slots), self.alpha)
        if imr.sdeg == 2:
            imr = ev.rescale(imr)

        out = self._fold(self._batch_sum(self._placed(imr, inp, b) for b in self.batches))
        return ev.gather(out) if limb_parallel else out
