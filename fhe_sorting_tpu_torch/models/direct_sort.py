"""DirectSort's plaintext masks and rotation sets (the staged path's part).

Port of the mask generators and BSGS helpers of
`fhe_sorting_tpu/models/direct_sort.py` ("Optimized Rank Sort for
Encrypted Real Numbers", eprint 2025/1170).  The sort itself is
`parallel/direct_staged.StagedDirectSort`.
"""

from __future__ import annotations

import math

import numpy as np


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
