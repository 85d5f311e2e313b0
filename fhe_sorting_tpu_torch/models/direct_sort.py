"""DirectSort: optimized SIMD rank sort for encrypted real numbers.

Port of `fhe_sorting_tpu/models/direct_sort.py` ("Optimized Rank Sort for
Encrypted Real Numbers", eprint 2025/1170):

  Phase 1  constructRank: pack num_partition shifted copies of the array
           into one ciphertext, one batched compare per batch computes
           N*num_partition comparisons at once; a log-tree rotate-fold
           accumulates ranks; the -0.5 self-comparison fix.
  Phase 2  rotationIndexCheckN: for each batch, a doubled-sinc Chebyshev
           indicator of (index - rank - check)/2N selects which slots travel
           to which rotation; masked inputs are blind-rotated with a
           baby-step/giant-step factorization and summed.

`DirectSort` calls one evaluator op at a time over the full key set
(`rotation_indices_direct_sort`); `parallel/direct_staged.StagedDirectSort`
is the same sort as named stages over the minimal key set.  Plaintext mask
vectors are generated on the host with numpy and encoded at the exact level
where they are consumed.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.cipher import Ciphertext
from ..ops.chebyshev import ChebyshevPS
from ..ops.compare import Comparison
from ..ops.rotation import RotationComposer
from ..ops.sign import CompositeSignConfig, SignConfig, SignFunc
from ..utils.sinc_coeffs import doubled_sinc_coefficients, sinc_coefficients
from .base import SortBase


def _default_np(num_partition: int, N: int) -> int:
    """Baby-step count of the BSGS mask-rotate factorizations: the nearest
    power of two to sqrt(num_partition)."""
    if num_partition <= 1:
        return 1
    return max(1, 1 << (int(math.log2(num_partition)) // 2))


def rotation_indices_direct_sort(N: int, ring_n: int) -> set:
    """Rotation amounts the per-op DirectSort requests: babies, giants,
    batch offsets and folds."""
    max_batch = ring_n // 2
    num_partition = min(N, max_batch // N)
    num_batch = N // num_partition
    num_slots = N * num_partition
    np_ = min(_default_np(num_partition, N), num_partition)
    idx = set(range(np_))
    idx.update(j * np_ for j in range(num_partition // np_))
    idx.update(i * np_ for i in range((num_slots // N) // np_))
    idx.update(b * num_partition for b in range(num_batch))
    idx.update(num_slots >> i for i in range(1, int(math.log2(num_partition)) + 1))
    idx.discard(0)
    return idx


def mask_block(num_slots: int, k: int, width: int) -> np.ndarray:
    """Ones on block k of the given width, zeros elsewhere."""
    v = np.zeros(num_slots)
    v[k * width : (k + 1) * width] = 1.0
    return v


def index_vector(N: int) -> np.ndarray:
    return np.arange(N, dtype=np.float64)


def checking_vector_n(N: int, num_slots: int, k: int) -> np.ndarray:
    """Partition j of width N holds (k + j) mod N."""
    ks = (k + np.arange(num_slots // N)) % N
    return np.repeat(ks.astype(np.float64), N)


def checking_vector_2n(N: int, num_slots: int, k: int) -> np.ndarray:
    """Blocks of width N in pairs [c | -N + c], c = k, k+1, ... mod N."""
    blocks = np.arange(-(-num_slots // N))
    cur = (k + blocks // 2) % N
    vals = np.where(blocks % 2 == 0, cur, cur - N).astype(np.float64)
    return np.repeat(vals, N)[:num_slots]


def _np_2n(num_partition: int) -> int:
    """Baby-step count for the 2N variant: largest power of two with
    np^2 <= num_partition/2."""
    half = max(1, num_partition // 2)
    np_ = 1 << (half.bit_length() - 1 >> 1)
    if np_ * np_ > half:
        np_ >>= 1
    return max(1, np_)


def rotation_indices_direct_sort_2n(N: int, ring_n: int) -> set:
    """Key set for the sinc (non-doubled) rotationIndexCheck2N placement,
    plus constructRank's needs."""
    max_batch = ring_n // 2
    idx = rotation_indices_direct_sort(N, ring_n)
    num_partition = min(2 * N, max_batch // N)
    num_batch = 2 * N // num_partition
    num_slots = num_partition * N
    np_ = _np_2n(num_partition)
    group = num_slots // N // 2           # partitions of width 2N
    for b in range(num_batch):
        for i in range(np_):
            idx.add(b * group + i)        # pre-rotations
    for i in range(group // np_):
        idx.add(i * np_)                  # giant steps
    for i in range(1, int(math.log2(num_partition)) + 1):
        idx.add(num_slots >> i)
    idx.discard(0)
    return idx


def rotation_indices_direct_sort_hybrid(N: int, ring_n: int,
                                        max_array: int = 256) -> set:
    """Key set for the hybrid placement (sumColumnsToTarget /
    transposeColumnTarget binary paths + batch rotations)."""
    idx = rotation_indices_direct_sort(N, ring_n)
    size = min(N, max_array)
    step = size >> 1
    while step:
        idx.update({step, -step})
        step >>= 1
    step = size * (size - 1) // 2
    for _ in range(int(math.log2(size))):
        idx.update({step, -step})
        step >>= 1
    for b in range(1, max(1, N // max_array)):
        idx.add(b * max_array)
    idx.discard(0)
    return idx


class DirectSort(SortBase):
    def __init__(self, ev, N: int,
                 rot: RotationComposer | None = None,
                 lazy_key_budget: int | None = None):
        """`lazy_key_budget`: generate rotation keys on device just-in-time
        with an LRU pool of that size (ops/rotation.py) - required at
        N >= 512 where the distinct giant-step keys would exceed device memory."""
        super().__init__(ev, N)
        self.max_batch = ev.ctx.params.ring_n // 2
        # capacity precondition: at least one shifted copy of the array must
        # fit a ciphertext (num_partition >= 1)
        assert N <= self.max_batch, (
            f"N={N} exceeds slot capacity {self.max_batch}"
        )
        self.comp = Comparison(ev)
        self.ps = ChebyshevPS(ev)
        steps = sorted(rotation_indices_direct_sort(N, ev.ctx.params.ring_n))
        self.rot = rot or RotationComposer(ev, steps,
                                           lazy_key_budget=lazy_key_budget)

    # -- phase 1: rank construction ---------------------------------------

    def _vec_rots_opt(self, babies, num_partition, num_slots, np_, is_):
        """BSGS masked-rotation generator: builds the ciphertext whose
        partition k holds the array left-rotated by is_*num_partition + k."""
        ev = self.ev
        base = mask_block(num_slots, 0, self.N)
        outer = []
        for j in range(num_partition // np_):
            T = None
            for i in range(np_):
                # every mask is a roll of the base N-block: rolled on device
                # (plaintext automorphism) instead of encoded per position
                r = (np_ * j + i) * self.N + is_ * num_partition + j * np_
                term = ev.mult_plain_at(babies[i], base, roll=r)
                T = term if T is None else ev.add(T, term)
            outer.append(self.rot.rotate(T, is_ * num_partition + j * np_))
        return ev.add_many(outer)

    def construct_rank(self, ct: Ciphertext, sign_func: SignFunc,
                       cfg: SignConfig) -> Ciphertext:
        """rank_j = sum_i 1[x_j > x_i] - 0.5."""
        ev = self.ev
        N = self.N
        num_partition = min(N, self.max_batch // N)
        num_batch = N // num_partition
        num_slots = N * num_partition
        np_ = min(_default_np(num_partition, N), num_partition)

        rank = None
        dup = ct.set_slots(num_slots)
        for is_ in range(num_batch):
            # uniform batches: rotate the INPUT by the batch offset first, so
            # every batch reuses batch-0's masks and giant-step keys
            # (rot(x, b*P + j*np) = rot(rot(x, b*P), j*np); the sharded
            # multi-chip path, parallel/direct_sharded.py, has the same form)
            u = self.rot.rotate(ct, is_ * num_partition) if is_ else ct
            babies = []
            for i in range(np_):
                t = self.rot.rotate(u, i) if i else u
                babies.append(t.set_slots(num_slots))
            shifted = self._vec_rots_opt(babies, num_partition, num_slots,
                                         np_, 0)
            cmp = self.comp.compare(dup, shifted, sign_func, cfg)
            rank = cmp if rank is None else ev.add(rank, cmp)
            self.log_phase(f"constructRank batch {is_+1}/{num_batch}", rank)

        for i in range(1, int(math.log2(num_partition)) + 1):
            rank = ev.add(rank, self.rot.rotate(rank, num_slots >> i))
        rank = rank.set_slots(N)
        return ev.sub(rank, 0.5)

    # -- phase 2: blind rotation by rank ----------------------------------

    def _blind_rotation_opt_n(self, masked, num_slots, np_, ib, num_partition):
        """giant-step accumulation of pre-rotated masked
        inputs."""
        ev = self.ev
        base = mask_block(num_slots, 0, self.N)
        result = None
        for i in range((num_slots // self.N) // np_):
            tmp = None
            for j in range(np_):
                r = (np_ * i + j) * self.N - j
                term = ev.mult_plain_at(masked[j], base, roll=r)
                tmp = term if tmp is None else ev.add(tmp, term)
            tmp = self.rot.rotate(tmp, ib * num_partition + i * np_)
            result = tmp if result is None else ev.add(result, tmp)
        return result

    def rotation_index_check_n(self, rank: Ciphertext,
                               ct: Ciphertext) -> Ciphertext:
        """place each element at its rank position."""
        ev = self.ev
        N = self.N
        num_partition = min(N, self.max_batch // N)
        num_batch = N // num_partition
        num_slots = N * num_partition
        np_ = min(_default_np(num_partition, N), num_partition)

        if rank.sdeg == 2:
            rank = ev.rescale(rank)  # keep index-vector encode within 2^62
        idx_pt = ev.make_plaintext(
            index_vector(self.N), rank.level, rank.sdeg, slots=N
        )
        index_minus_rank = ev.rsub(idx_pt, rank)
        index_minus_rank = index_minus_rank.set_slots(num_slots)
        input2 = ct.set_slots(num_slots)

        # stretch the Chebyshev domain so rank noise (up to ~4 rank units)
        # cannot push the argument outside [-1, 1] where T_deg explodes
        stretch = 1.0 + 4.0 / N
        coeffs = doubled_sinc_coefficients(N, stretch=stretch)
        # scale into the Chebyshev domain ONCE (each batch then subtracts a
        # pre-scaled plaintext checking vector - saves num_batch-1 rescales)
        alpha = 1.0 / (2.0 * N * stretch)
        index_minus_rank = ev.mult(index_minus_rank, alpha)
        out = None
        for b in range(num_batch):
            check = checking_vector_n(N, num_slots, b * num_partition)
            rot_index = ev.sub(
                index_minus_rank,
                ev.make_plaintext(check * alpha, index_minus_rank.level,
                                  index_minus_rank.sdeg, slots=num_slots),
            )
            rot_index = self.ps.evaluate(rot_index, coeffs)
            masked = ev.mult(rot_index, input2)
            pre = ev.rotate_precompute(masked)
            masked_rots = [
                self.rot.rotate_hoisted(masked, pre, i) if i else masked
                for i in range(np_)
            ]
            # uniform batches: accumulate with batch-0 giants, then apply
            # the batch offset to the sum (one rotation per batch)
            rotated = self._blind_rotation_opt_n(
                masked_rots, num_slots, np_, 0, num_partition
            )
            if b:
                rotated = self.rot.rotate(rotated, b * num_partition)
            out = rotated if out is None else ev.add(out, rotated)
            self.log_phase(f"rotationIndexCheck batch {b+1}/{num_batch}", out)

        for i in range(1, int(math.log2(num_partition)) + 1):
            out = ev.add(out, self.rot.rotate(out, num_slots >> i))
        return out.set_slots(N)

    # -- 2N variant: plain-sinc placement ------------

    def _blind_rotation_opt_2n(self, masked, num_slots, np_):
        """giant-step accumulation over 2N-wide
        partitions."""
        ev = self.ev
        group = num_slots // self.N // 2
        base = mask_block(num_slots, 0, 2 * self.N)
        result = None
        for i in range(group // np_):
            tmp = None
            for j in range(np_):
                r = (np_ * i + j) * 2 * self.N - j
                term = ev.mult_plain_at(masked[j], base, roll=r)
                tmp = term if tmp is None else ev.add(tmp, term)
            tmp = self.rot.rotate(tmp, i * np_)
            result = tmp if result is None else ev.add(result, tmp)
        return result

    def rotation_index_check_2n(self, rank: Ciphertext,
                                ct: Ciphertext) -> Ciphertext:
        """like rotation_index_check_n but each batch
        carries [k | -N+k] checking pairs over 2N-wide partitions, so a plain
        scaled sinc (no doubling) indicates the rotation amount."""
        ev = self.ev
        N = self.N
        num_partition = min(2 * N, self.max_batch // N)
        num_batch = 2 * N // num_partition
        num_slots = num_partition * N
        np_ = _np_2n(num_partition)
        group = num_slots // N // 2

        if rank.sdeg == 2:
            rank = ev.rescale(rank)
        idx_pt = ev.make_plaintext(
            index_vector(self.N), rank.level, rank.sdeg, slots=N
        )
        index_minus_rank = ev.rsub(idx_pt, rank).set_slots(num_slots)
        input2 = ct.set_slots(num_slots)

        stretch = 1.0 + 4.0 / N
        coeffs = sinc_coefficients(N, stretch=stretch)
        alpha = 1.0 / (2.0 * N * stretch)
        index_minus_rank = ev.mult(index_minus_rank, alpha)
        out = None
        for b in range(num_batch):
            check = checking_vector_2n(N, num_slots, b * group)
            rot_index = ev.sub(
                index_minus_rank,
                ev.make_plaintext(check * alpha, index_minus_rank.level,
                                  index_minus_rank.sdeg, slots=num_slots),
            )
            rot_index = self.ps.evaluate(rot_index, coeffs)
            masked = ev.mult(rot_index, input2)
            pre = ev.rotate_precompute(masked)
            masked_rots = [
                self.rot.rotate_hoisted(masked, pre, b * group + i)
                if b * group + i else masked
                for i in range(np_)
            ]
            rotated = self._blind_rotation_opt_2n(masked_rots, num_slots, np_)
            out = rotated if out is None else ev.add(out, rotated)

        for i in range(1, int(math.log2(num_partition)) + 1):
            out = ev.add(out, self.rot.rotate(out, num_slots >> i))
        return out.set_slots(N)

    # -- hybrid variant (MEHP24-style placement) -----

    def _binary_path(self, index: int, size: int):
        lg = int(math.log2(size))
        return [(index >> (lg - 1 - i)) & 1 for i in range(lg)]

    def sum_columns_to_target(self, c: Ciphertext, size: int, col: int,
                              mask_output: bool) -> Ciphertext:
        """log-fold columns into target column `col`
        following its binary path."""
        ev = self.ev
        c = c.set_slots(size * size)
        step = size >> 1
        for bit in self._binary_path(col, size):
            c = ev.add(c, self.rot.rotate(c, -step if bit else step))
            step >>= 1
        if mask_output:
            m = np.zeros(size * size)
            m[col :: size] = 1.0
            c = ev.mult_plain_at(c, m)
        return c

    def transpose_column_target(self, c: Ciphertext, size: int, row: int,
                                mask_output: bool) -> Ciphertext:
        """Log-fold rows into target row `row` following its binary path
        (the transpose counterpart of `sum_columns_to_target`)."""
        ev = self.ev
        c = c.set_slots(size * size)
        step = size * (size - 1) // 2
        for bit in self._binary_path(row, size):
            c = ev.add(c, self.rot.rotate(c, -step if bit else step))
            step >>= 1
        if mask_output:
            m = np.zeros(size * size)
            m[size * row : size * (row + 1)] = 1.0
            c = ev.mult_plain_at(c, m)
        return c

    # Hybrid placement thresholds.  Class attrs
    # so tests can exercise the batched / sign-indicator branches at small N
    # and small rings (they are otherwise reached only at N>=256, ring 2^17).
    hybrid_max_array: int = 256      # maxArraySize: N x N tile capacity
    hybrid_sinc_threshold: int = 256  # below: sinc Chebyshev; above: sign
    hybrid_indicator_dg: int | None = None  # override indicator g-iterations

    def rotation_index_check_hybrid(self, rank: Ciphertext, ct: Ciphertext,
                                    sign_func=SignFunc.CompositeSign
                                    ) -> Ciphertext:
        """N x N-matrix placement via a sinc (N<256)
        or sign-indicator (N>=256) of (i/N - rank/N)."""
        ev, N = self.ev, self.N
        max_array = self.hybrid_max_array
        if N > max_array:
            num_slots = self.max_batch
            num_batch = N // max_array
        else:
            num_slots = N * N
            num_batch = 1
        assert num_slots <= self.max_batch
        size = min(N, max_array)

        if rank.sdeg == 2:
            rank = ev.rescale(rank)
        stretch = 1.0 + 8.0 / N
        rank = rank.set_slots(num_slots)
        r = ev.mult(rank, 1.0 / (N * stretch))
        inp = ct.set_slots(num_slots)

        rots_rank = [self.rot.rotate(r, b * max_array) for b in range(num_batch)]
        rots_inp = [self.rot.rotate(inp, b * max_array) for b in range(num_batch)]

        masked = []
        for b in range(num_batch):
            sub_mask = np.zeros(num_slots)
            for i in range(size):
                sub_mask[i * size : (i + 1) * size] = (
                    (b * size + i) / (N * stretch)
                )
            sub_pt = ev.make_plaintext(sub_mask, r.level, r.sdeg,
                                       slots=num_slots)
            acc = None
            for k in range(num_batch):
                rm = ev.rsub(sub_pt, rots_rank[k])
                if N < self.hybrid_sinc_threshold:
                    rm = self.ps.evaluate(rm, sinc_coefficients(N, stretch=stretch))
                else:
                    # dg 4 below N=512, else 5; tests
                    # scale the branch down via hybrid_indicator_dg
                    dgi = self.hybrid_indicator_dg or (4 if N < 512 else 5)
                    cfg_i = SignConfig(CompositeSignConfig(3, dgi, 2))
                    rm = self.comp.indicator(rm, 0.5 / (N * stretch),
                                                  sign_func, cfg_i)
                term = ev.mult(rots_inp[k], rm)
                acc = term if acc is None else ev.add(acc, term)
            acc = self.sum_columns_to_target(acc, N // num_batch, b, True)
            masked.append(self.transpose_column_target(acc, N // num_batch, b, True))
        return ev.add_many(masked)

    def sort_hybrid(self, ct: Ciphertext,
                    sign_func: SignFunc = SignFunc.CompositeSign,
                    cfg: SignConfig | None = None) -> Ciphertext:
        """constructRank, then the hybrid placement."""
        cfg = cfg or SignConfig()
        rank = self.construct_rank(ct, sign_func, cfg)
        return self.rotation_index_check_hybrid(rank, ct, sign_func)

    # -- public API --------------------------------------------------------

    def sort(self, ct: Ciphertext, sign_func: SignFunc = SignFunc.CompositeSign,
             cfg: SignConfig | None = None) -> Ciphertext:
        cfg = cfg or SignConfig()
        rank = self.construct_rank(ct, sign_func, cfg)
        return self.rotation_index_check_n(rank, ct)
