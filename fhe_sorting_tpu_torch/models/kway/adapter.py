"""KWayAdapter: the k-way sorter behind the SortBase interface.

Port of `fhe_sorting_tpu/models/kway/adapter.py` (the reference's
kway_adapter.h).
"""

from __future__ import annotations

from ...core.cipher import Ciphertext
from ...ops.sign import SignConfig, SignFunc
from ..base import SortBase
from .sorter import KWaySorter


def kway_decompose(N: int):
    """(k, M) with k^M == N, preferring the larger k (kway_adapter.h:36)."""
    for k in (5, 3, 2):
        M = 0
        v = N
        while v % k == 0:
            v //= k
            M += 1
        if v == 1 and M > 0:
            return k, M
    raise ValueError(f"N={N} is not a power of 2, 3 or 5")


class KWayAdapter(SortBase):
    def __init__(self, ev, N: int, bootstrap_fn=None):
        self.ev = ev
        self.N = N
        k, M = kway_decompose(N)
        self.sorter = KWaySorter(ev, k, M, bootstrap_fn=bootstrap_fn)

    def sort(self, ct: Ciphertext, sign_func: SignFunc = SignFunc.CompositeSign,
             cfg: SignConfig | None = None) -> Ciphertext:
        return self.sorter.sort(ct, sign_func, cfg or SignConfig())
