"""BitonicSort: classic log^2 N sorting network with masked compare-and-swap.

Port of `fhe_sorting_tpu/models/bitonic.py`: per (k, j) stage, four plaintext masks split slots into ascending/descending comparator
lanes, +-j rotations align partners, and a single batched compare + two
multiplies perform every compare-and-swap of the stage at once.

The network refreshes the ciphertext when its level exceeds
`bootstrap_level`: pass a `bootstrap_fn` (e.g. a `core/bootstrap.py`
Bootstrapper closure), or provision enough depth for the whole network."""

from __future__ import annotations

import numpy as np

from ..core.cipher import Ciphertext
from ..core.evaluator import Evaluator
from ..ops.compare import Comparison
from ..ops.rotation import RotationComposer
from ..ops.sign import SignConfig, SignFunc
from .base import SortBase


def rotation_indices_bitonic(N: int) -> set:
    idx = set()
    j = 1
    while j < N:
        idx.add(j)
        idx.add(-j)
        j *= 2
    return idx


class BitonicSort(SortBase):
    def __init__(self, ev: Evaluator, N: int, normalize: float = 255.0,
                 bootstrap_fn=None, bootstrap_level: int | None = None,
                 rot: RotationComposer | None = None):
        super().__init__(ev, N)
        self.comp = Comparison(ev)
        self.rot = rot or RotationComposer(ev, rotation_indices_bitonic(N))
        self.normalize = normalize
        self.bootstrap_fn = bootstrap_fn
        self.bootstrap_level = bootstrap_level

    def _compare_and_swap(self, a1, a2, a3, a4, func, cfg):
        ev = self.ev
        c = self.comp.compare(a1, a2, func, cfg)
        t1 = ev.mult(c, a3)
        t2 = ev.mult(ev.rsub(1.0, c), a4)
        return ev.add(t1, t2)

    def sort(self, ct: Ciphertext, sign_func: SignFunc = SignFunc.CompositeSign,
             cfg: SignConfig | None = None) -> Ciphertext:
        ev, N = self.ev, self.N
        cfg = cfg or SignConfig()
        result = ct
        if self.normalize != 1.0:
            result = ev.mult(result, 1.0 / self.normalize)

        k = 2
        while k <= N:
            j = k // 2
            while j > 0:
                if (self.bootstrap_fn is not None
                        and self.bootstrap_level is not None
                        and result.level > self.bootstrap_level):
                    result = self.bootstrap_fn(result)
                m1 = np.zeros(N)
                m2 = np.zeros(N)
                m3 = np.zeros(N)
                m4 = np.zeros(N)
                for i in range(N):
                    l = i ^ j
                    if i < l:
                        if (i & k) == 0:
                            m1[i] = 1.0
                            m2[l] = 1.0
                        else:
                            m3[i] = 1.0
                            m4[l] = 1.0
                arr1 = ev.mult_plain_at(result, m1)
                arr2 = ev.mult_plain_at(result, m2)
                arr3 = ev.mult_plain_at(result, m3)
                arr4 = ev.mult_plain_at(result, m4)

                arr5_1 = self.rot.rotate(arr1, -j)
                arr5_2 = self.rot.rotate(arr3, -j)
                arr6_1 = self.rot.rotate(arr2, j)
                arr6_2 = self.rot.rotate(arr4, j)

                arr7 = ev.add(ev.add(arr5_1, arr5_2), ev.add(arr6_1, arr6_2))
                arr8 = result
                arr9 = ev.add(ev.add(arr5_1, arr1), ev.add(arr6_2, arr4))
                arr10 = ev.add(ev.add(arr5_2, arr3), ev.add(arr6_1, arr2))

                result = self._compare_and_swap(
                    arr7, arr8, arr9, arr10, sign_func, cfg
                )
                j //= 2
            k *= 2

        if self.normalize != 1.0:
            result = ev.mult(result, self.normalize)
        return result
