"""k-way min/max algebra and slot-lane alignment.

Port of `fhe_sorting_tpu/models/kway/sort_utils.py` (the reference's
SortUtils.cpp): the {two,three,four,five}-sorter comparison algebra
(fcnL(a,b,c) = c*(a-b)+b, sum-minus-extremes tricks) and the slotMatching
lane rotations that align each sorter's operands and flip mirrored
comparisons.
"""

from __future__ import annotations

import numpy as np

from ...ops.rotation import RotationComposer
from .masking import gen_mask


class SortUtils:
    def __init__(self, ev, rot: RotationComposer, num_slots: int):
        self.ev = ev
        self.rot = rot
        self.num_slots = num_slots

    # -- primitives (SortUtils.cpp:5-54) ----------------------------------

    def fcn_l(self, a, b, comp):
        """comp*(a-b) + b: max if comp=(a>b), min with swapped args."""
        ev = self.ev
        return ev.add(ev.mult(ev.sub(a, b), comp), b)

    def compare_max(self, a, b, comp):
        return self.fcn_l(a, b, comp)

    def compare_min(self, a, b, comp):
        return self.fcn_l(b, a, comp)

    def two_sorter(self, a, b, comp):
        ev = self.ev
        mx = self.fcn_l(a, b, comp)
        mn = ev.sub(ev.add(a, b), mx)
        return [mn, mx]

    def three_sorter(self, c, comp):
        """c = [a,b,cc]; comp = [(a>b),(a>c),(b>c)] (SortUtils.cpp:56-78)."""
        ev = self.ev
        mm1 = self.two_sorter(c[0], c[1], comp[0])
        mm1_vs_c = self.two_sorter(comp[1], comp[2], comp[0])
        mx = self.compare_max(mm1[1], c[2], mm1_vs_c[1])
        mn = self.compare_min(mm1[0], c[2], mm1_vs_c[0])
        mid = ev.sub(ev.sub(ev.add(ev.add(c[0], c[1]), c[2]), mn), mx)
        return [mn, mid, mx]

    def four_sorter(self, c, comp):
        """comp = [a>b, a>c, a>d, b>c, b>d, c>d] (SortUtils.cpp:80-129)."""
        ev = self.ev
        mm1 = self.two_sorter(c[0], c[1], comp[0])
        mm2 = self.two_sorter(c[2], c[3], comp[5])
        mm1_vs_c = self.two_sorter(comp[1], comp[3], comp[0])
        mm1_vs_d = self.two_sorter(comp[2], comp[4], comp[0])
        M1_vs_mm2 = self.two_sorter(mm1_vs_c[1], mm1_vs_d[1], comp[5])
        m1_vs_mm2 = self.two_sorter(mm1_vs_c[0], mm1_vs_d[0], comp[5])

        s3 = self.compare_max(mm1[1], mm2[1], M1_vs_mm2[1])
        left = self.compare_max(mm1[0], mm2[1], m1_vs_mm2[1])
        right = self.compare_max(mm1[1], mm2[0], M1_vs_mm2[0])
        s2 = self.compare_max(left, right, M1_vs_mm2[1])
        s0 = self.compare_min(mm1[0], mm2[0], m1_vs_mm2[0])
        total = c[0]
        for i in range(1, 4):
            total = ev.add(total, c[i])
        s1 = ev.sub(ev.sub(ev.sub(total, s0), s2), s3)
        return [s0, s1, s2, s3]

    def five_sorter(self, c, comp):
        """comp = [a>b a>c a>d a>e b>c b>d b>e c>d c>e d>e]
        (SortUtils.cpp:131-200: 3+2 merge, middle by subtraction)."""
        ev = self.ev
        abc_comp = [comp[0], comp[1], comp[4]]
        abc = self.three_sorter([c[0], c[1], c[2]], abc_comp)
        de = self.two_sorter(c[3], c[4], comp[9])

        abc_vs_d = self.three_sorter([comp[2], comp[5], comp[7]], abc_comp)
        abc_vs_e = self.three_sorter([comp[3], comp[6], comp[8]], abc_comp)

        M1_vs_mm2 = self.two_sorter(abc_vs_d[2], abc_vs_e[2], comp[9])
        D1_vs_mm2 = self.two_sorter(abc_vs_d[1], abc_vs_e[1], comp[9])
        m1_vs_mm2 = self.two_sorter(abc_vs_d[0], abc_vs_e[0], comp[9])

        s4 = self.compare_max(abc[2], de[1], M1_vs_mm2[1])
        s0 = self.compare_min(abc[0], de[0], m1_vs_mm2[0])

        left = self.compare_max(abc[1], de[1], D1_vs_mm2[1])
        right = self.compare_max(abc[2], de[0], M1_vs_mm2[0])
        s3 = self.compare_max(left, right, M1_vs_mm2[1])

        left = self.compare_min(abc[1], de[0], D1_vs_mm2[0])
        right = self.compare_min(abc[0], de[1], m1_vs_mm2[1])
        s1 = self.compare_min(left, right, m1_vs_mm2[0])

        total = c[0]
        for i in range(1, 5):
            total = ev.add(total, c[i])
        s2 = total
        for s in (s0, s1, s3, s4):
            s2 = ev.sub(s2, s)
        return [s0, s1, s2, s3, s4]

    # -- lane alignment (SortUtils.cpp:202-423) ---------------------------

    def _flip(self, ct, mask: np.ndarray):
        """mask - ct (EvalUtils flipCtxt with mask)."""
        ev = self.ev
        neg = ev.negate(ct)
        pt = ev.make_plaintext(mask, neg.level, neg.sdeg, slots=self.num_slots)
        return ev.add(neg, pt)

    def slot_matching2(self, ct, comp, indices, shift):
        arr = [ct, self.rot.rotate(ct, shift)]
        return arr, comp

    def slot_matching3(self, ct, comp, indices, shift):
        mask3 = gen_mask(indices, 3, 1)
        arr = [self.rot.rotate(ct, i * shift) for i in range(3)]
        comp_arr = [
            self._flip(self.rot.rotate(comp, shift), mask3),
            comp,
            self._flip(self.rot.rotate(comp, 2 * shift), mask3),
        ]
        return arr, comp_arr

    def slot_matching4(self, ct, comp1, comp2, indices, shift):
        mask4 = gen_mask(indices, 4, 1)
        comp_arr = [None] * 6
        comp_arr[2] = comp1                                   # a > b... lane 2
        comp_arr[0] = self.rot.rotate(comp1, shift)
        comp_arr[3] = self.rot.rotate(comp1, 2 * shift)
        comp_arr[5] = self.rot.rotate(comp1, 3 * shift)
        comp_arr[1] = comp2
        comp_arr[4] = self.rot.rotate(comp2, shift)
        for i in (0, 3, 5):
            comp_arr[i] = self._flip(comp_arr[i], mask4)
        arr = []
        for i in range(4):
            r = self.rot.rotate(ct, i * shift)
            arr.append(self.ev.mult_plain_at(r, mask4))
        return arr, comp_arr

    def slot_matching5(self, ct, comp1, comp2, indices, shift):
        mask5 = gen_mask(indices, 5, 1)
        arr = [self.rot.rotate(ct, i * shift) for i in range(5)]
        comp_arr = [None] * 10
        comp_arr[3] = comp1
        comp_arr[0] = self.rot.rotate(comp1, shift)
        comp_arr[4] = self.rot.rotate(comp1, 2 * shift)
        comp_arr[7] = self.rot.rotate(comp1, 3 * shift)
        comp_arr[9] = self.rot.rotate(comp1, 4 * shift)
        comp_arr[2] = comp2
        comp_arr[6] = self.rot.rotate(comp2, shift)
        comp_arr[1] = self.rot.rotate(comp2, 2 * shift)
        comp_arr[5] = self.rot.rotate(comp2, 3 * shift)
        comp_arr[8] = self.rot.rotate(comp2, 4 * shift)
        for i in (0, 1, 4, 5, 7, 8, 9):
            comp_arr[i] = self._flip(comp_arr[i], mask5)
        return arr, comp_arr

    def slot_matching2345(self, ct, comp1, comp2, indices, shift):
        """Mixed-size stage (SortUtils.cpp:324-423)."""
        ev = self.ev
        arr = [self.rot.rotate(ct, i * shift) for i in range(5)]

        m2345 = np.zeros(self.num_slots)
        m45 = np.zeros(self.num_slots)
        m345 = np.zeros(self.num_slots)
        m3 = gen_mask(indices, 3, 1)
        m4 = gen_mask(indices, 4, 1)
        m5 = gen_mask(indices, 5, 1)
        for sz in (2, 3, 4, 5):
            sel = gen_mask(indices, sz, 1)
            m2345 += sel
            if sz >= 3:
                m345 += sel
            if sz >= 4:
                m45 += sel

        comp_arr = [None] * 10
        # a > b
        comp_arr[0] = self._flip(self.rot.rotate(comp1, shift), m2345)
        # a > c
        tmp = ev.mult_plain_at(comp1, m3)
        tmp2 = self.rot.rotate(comp2, 2 * shift)
        tmp2 = self._flip(ev.mult_plain_at(tmp2, m45), m45)
        comp_arr[1] = ev.add(tmp, tmp2)
        # a > d
        comp_arr[2] = ev.add(
            ev.mult_plain_at(comp1, m4), ev.mult_plain_at(comp2, m5)
        )
        # a > e
        comp_arr[3] = ev.mult_plain_at(comp1, m5)
        # b > c
        t = ev.mult_plain_at(self.rot.rotate(comp1, 2 * shift), m345)
        comp_arr[4] = self._flip(t, m345)
        # b > d
        t = ev.mult_plain_at(self.rot.rotate(comp2, 3 * shift), m45)
        comp_arr[5] = self._flip(t, m45)
        # b > e
        comp_arr[6] = ev.mult_plain_at(self.rot.rotate(comp2, shift), m5)
        # c > d
        t = ev.mult_plain_at(self.rot.rotate(comp1, 3 * shift), m45)
        comp_arr[7] = self._flip(t, m45)
        # c > e
        t = ev.mult_plain_at(self.rot.rotate(comp2, 4 * shift), m5)
        comp_arr[8] = self._flip(t, m5)
        # d > e
        t = ev.mult_plain_at(self.rot.rotate(comp1, 4 * shift), m5)
        comp_arr[9] = self._flip(t, m5)
        return arr, comp_arr

    def slot_assemble(self, sorted_cts, shift):
        out = sorted_cts[0]
        for i in range(1, len(sorted_cts)):
            out = self.ev.add(out, self.rot.rotate(sorted_cts[i], -i * shift))
        return out
