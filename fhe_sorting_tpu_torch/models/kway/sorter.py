"""k-way sorting network: the stage loop ([HKC+21]; k in {2, 3, 5}).

Port of `fhe_sorting_tpu/models/kway/sorter.py` (the reference's
Sorter.cpp:8-404): per stage, `sort_type` yields the (m, logDist, slope)
schedule, `gen_indices` labels the lanes, `_right_rotate_for_sort` aligns
comparison partners (with the slope-dependent wrap fixups), one or two
batched compares feed the {two..five}-sorter min/max algebra, and
`slot_assemble` recombines lanes.

Bootstrapping (checkLevelAndBoot, EvalUtils.cpp:57-86) hooks in through an
optional `bootstrap_fn`, which also reaches the sign layer's mid-compare
refresh; without one the network runs on the chain's depth alone.
"""

from __future__ import annotations

import numpy as np

from ...core.cipher import Ciphertext
from ...ops.compare import Comparison
from ...ops.rotation import RotationComposer
from ...ops.sign import SignConfig, SignFunc
from ..base import SortBase
from .eval_utils import check_level_and_boot
from .masking import gen_indices, gen_mask, get_rotate_distance, num_stages, sort_type
from .sort_utils import SortUtils

# Required remaining levels before each sorter size (Sorter.h:86-93)
SORTER_LEVELS = {0: 0, 1: 1, 2: 3, 3: 5, 4: 6, 5: 7}


def rotation_indices_kway(N: int) -> set:
    """Signed powers of two below N: the default composer's key basis."""
    idx = set()
    p = 1
    while p < N:
        idx.update({p, -p})
        p *= 2
    return idx


class KWaySorter(SortBase):
    def __init__(self, ev, k: int, M: int,
                 bootstrap_fn=None, rot: RotationComposer | None = None):
        assert k in (2, 3, 5), "only k=2,3,5 supported (Sorter.cpp:289)"
        N = k ** M
        self.k = k
        self.M = M
        self.ev = ev
        self.N = N
        # CKKS slot counts are powers of two: pad the k^M lanes with zeros
        # (kway_adapter.h:41-48 parity: batch = next power of two >= N).
        self.num_slots = 1 << (N - 1).bit_length()
        self.comp = Comparison(ev)
        self.rot = rot or RotationComposer(
            ev, rotation_indices_kway(self.num_slots * 2), wrap=self.num_slots
        )
        self.utils = SortUtils(ev, self.rot, self.num_slots)
        self.bootstrap_fn = bootstrap_fn

    # -- stage plumbing (Sorter.cpp:180-282) ------------------------------

    def _check_boot(self, ct, required_level):
        """checkLevelAndBoot (EvalUtils.cpp:57-86); without a bootstrap_fn
        it does nothing, and a chain too shallow fails at its rescale."""
        if self.bootstrap_fn is None:
            return ct
        return check_level_and_boot(self.ev, ct, required_level, self.bootstrap_fn)

    def _right_rotate_for_sort(self, ct, indices, log_dist, slope):
        """Sorter.cpp:180-249: align comparison partners with wrap fixups.
        Returns (ctxt_rot, ctxt_fix)."""
        ev, k = self.ev, self.k
        mask_left = (indices[1] < indices[0]).astype(np.float64)
        mask_right = [
            ((indices[0] == i + 1) & (indices[1] == i + 1)).astype(np.float64)
            for i in range(k)
        ]
        ct_left = ev.mult_plain_at(ct, mask_left)
        rot = get_rotate_distance(k, log_dist, slope)

        if slope == 0:
            ct_right = ev.mult_plain_at(ct, mask_right[k - 1])
            rot_right = self.rot.rotate(ct_right, (k - 1) * rot)
            ct_rot = ev.add(self.rot.rotate(ct_left, -rot), rot_right)
            return ct_rot, None
        if slope == k // 2 + 1:
            ct_right = ev.mult_plain_at(ct, mask_right[k - 2])
            fix = ev.sub(ev.sub(ct, ct_left), ct_right)
            rot_right = self.rot.rotate(ct_right, (k - 2) * rot)
            ct_rot = ev.add(self.rot.rotate(ct_left, -rot), rot_right)
            return ct_rot, fix
        rights = [ev.mult_plain_at(ct, mask_right[i]) for i in range(k)]
        fix = ev.sub(ct, ct_left)
        for r in rights:
            fix = ev.sub(fix, r)
        ct_rot = self.rot.rotate(ct_left, -rot)
        for i in range(1, k):
            ct_rot = ev.add(ct_rot, self.rot.rotate(rights[i], i * rot))
        return ct_rot, fix

    def _comparison_for_sort(self, ct, indices, log_dist, slope, cfg):
        ct_rot, fix = self._right_rotate_for_sort(ct, indices, log_dist, slope)
        c = self.comp.compare(ct, ct_rot, SignFunc.CompositeSign, cfg,
                              bootstrap_fn=self.bootstrap_fn)
        return c, fix

    def _comparison_for_sort2(self, ct, indices, log_dist, slope, cfg):
        ct_rot1, fix = self._right_rotate_for_sort(ct, indices, log_dist, slope)
        ct_rot2, _ = self._right_rotate_for_sort(
            ct_rot1, indices, log_dist, slope
        )
        c1 = self.comp.compare(ct, ct_rot1, SignFunc.CompositeSign, cfg,
                               bootstrap_fn=self.bootstrap_fn)
        c2 = self.comp.compare(ct, ct_rot2, SignFunc.CompositeSign, cfg,
                               bootstrap_fn=self.bootstrap_fn)
        return c1, c2, fix

    # -- per-size sorter runners (Sorter.cpp:8-178) -----------------------

    def _run_two(self, ct, indices, shift, comp):
        ev, u = self.ev, self.utils
        mask2 = gen_mask(indices, 2, 1)
        arr, _ = u.slot_matching2(ct, comp, indices, shift)
        srt = u.two_sorter(arr[0], arr[1], comp)
        srt = [ev.mult_plain_at(s, mask2) for s in srt]
        return ev.add(srt[0], self.rot.rotate(srt[1], -shift))

    def _run_three(self, ct, indices, shift, comp):
        ev, u = self.ev, self.utils
        mask3 = gen_mask(indices, 3, 1)
        arr, comp_arr = u.slot_matching3(ct, comp, indices, shift)
        srt = u.three_sorter(arr, comp_arr)
        srt = [ev.mult_plain_at(s, mask3) for s in srt]
        out = ev.add(srt[0], self.rot.rotate(srt[1], -shift))
        return ev.add(out, self.rot.rotate(srt[2], -2 * shift))

    def _run_four(self, ct, indices, shift, comp1, comp2):
        u = self.utils
        arr, comp_arr = u.slot_matching4(ct, comp1, comp2, indices, shift)
        srt = u.four_sorter(arr, comp_arr)
        return u.slot_assemble(srt, shift)

    def _run_five(self, ct, indices, shift, comp1, comp2):
        ev, u = self.ev, self.utils
        mask5 = gen_mask(indices, 5, 1)
        arr, comp_arr = u.slot_matching5(ct, comp1, comp2, indices, shift)
        srt = u.five_sorter(arr, comp_arr)
        srt = [ev.mult_plain_at(s, mask5) for s in srt]
        return u.slot_assemble(srt, shift)

    def _run_2345(self, ct, indices, shift, comp1, comp2):
        ev, u = self.ev, self.utils
        m3 = gen_mask(indices, 3, 1)
        m4 = gen_mask(indices, 4, 1)
        m5 = gen_mask(indices, 5, 1)
        m2345 = gen_mask(indices, 2, 1) + m3 + m4 + m5
        m345 = m3 + m4 + m5
        m45 = m4 + m5
        arr, comp_arr = u.slot_matching2345(ct, comp1, comp2, indices, shift)
        srt = u.five_sorter(arr, comp_arr)
        masks = [m2345, m2345, m345, m45, m5]
        srt = [ev.mult_plain_at(s, m) for s, m in zip(srt, masks)]
        return u.slot_assemble(srt, shift)

    # -- stage loop (Sorter.cpp:284-404) ----------------------------------

    def sort(self, ct: Ciphertext, sign_func: SignFunc = SignFunc.CompositeSign,
             cfg: SignConfig | None = None, stage_lo: int = 0,
             stage_hi: int | None = None) -> Ciphertext:
        """Run stages [stage_lo, stage_hi) (default: all)."""
        ev, k, M = self.ev, self.k, self.M
        cfg = cfg or SignConfig()
        L = SORTER_LEVELS
        hi = num_stages(k, M) if stage_hi is None else stage_hi
        for stage in range(stage_lo, hi):
            m, log_dist, slope = sort_type(k, M, stage)
            shift = get_rotate_distance(k, log_dist, slope)
            indices = np.zeros((2, self.num_slots), dtype=np.int64)
            indices[:, : k ** M] = gen_indices(k ** M, k, M, m, log_dist, slope)

            if slope == 0:
                ct = self._check_boot(ct, L[k])
                if k in (2, 3):
                    c1, fix = self._comparison_for_sort(
                        ct, indices, log_dist, slope, cfg
                    )
                    c1 = self._check_boot(c1, L[k])
                    ct = (self._run_two if k == 2 else self._run_three)(
                        ct, indices, shift, c1
                    )
                else:
                    c1, c2, fix = self._comparison_for_sort2(
                        ct, indices, log_dist, slope, cfg
                    )
                    c1 = self._check_boot(c1, L[k])
                    c2 = self._check_boot(c2, L[k])
                    ct = self._run_five(ct, indices, shift, c1, c2)
            elif slope == k // 2 + 1:
                ct = self._check_boot(ct, L[k - 1])
                if k == 3:
                    c1, fix = self._comparison_for_sort(
                        ct, indices, log_dist, slope, cfg
                    )
                    c1 = self._check_boot(c1, L[k - 1])
                    ct = ev.add(self._run_two(ct, indices, shift, c1), fix)
                else:  # k == 5
                    c1, c2, fix = self._comparison_for_sort2(
                        ct, indices, log_dist, slope, cfg
                    )
                    c1 = self._check_boot(c1, L[k - 1])
                    c2 = self._check_boot(c2, L[k - 1])
                    ct = ev.add(
                        self._run_four(ct, indices, shift, c1, c2), fix
                    )
            else:
                if k == 5 and slope == 1:
                    ct = self._check_boot(ct, L[5])
                    c1, c2, fix = self._comparison_for_sort2(
                        ct, indices, log_dist, slope, cfg
                    )
                    c1 = self._check_boot(c1, L[5])
                    c2 = self._check_boot(c2, L[5])
                    ct = ev.add(self._run_2345(ct, indices, shift, c1, c2), fix)
                elif (k == 5 and slope == 2) or (k == 3 and slope == 1):
                    ct = self._check_boot(ct, L[3])
                    c1, fix = self._comparison_for_sort(
                        ct, indices, log_dist, slope, cfg
                    )
                    c1 = self._check_boot(c1, L[3])
                    ct2 = self._run_two(ct, indices, shift, c1)
                    ct3 = self._run_three(ct, indices, shift, c1)
                    ct = ev.add(ev.add(ct2, fix), ct3)
                elif k == 2 and slope == 1:
                    ct = self._check_boot(ct, L[2])
                    c1, fix = self._comparison_for_sort(
                        ct, indices, log_dist, slope, cfg
                    )
                    c1 = self._check_boot(c1, L[2])
                    ct = ev.add(self._run_two(ct, indices, shift, c1), fix)
                else:
                    raise ValueError(f"no matching k={k} slope={slope}")
        return ct
