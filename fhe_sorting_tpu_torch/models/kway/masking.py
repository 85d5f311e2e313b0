"""k-way sorting network topology (pure plaintext math, numpy).

Port of `fhe_sorting_tpu/models/kway/masking.py` (the reference's
Masking.cpp, the [HKC+21] k-way sorting network), kept as this package's own
copy: `sort_type` maps a stage number to its (m, logDist, slope) schedule,
`gen_indices` labels every slot with its sorter size (indices[0]) and its
position within the sorter (indices[1]), and `get_rotate_distance` gives the
lane shift for a stage.
"""

from __future__ import annotations

import numpy as np


def sort_type(k: int, M: int, stage: int):
    """Masking.cpp:26-47: stage -> (m, logDist, slope)."""
    upperk = (k + 1) // 2
    r = 0
    while stage >= (r + 1 + r * (r + 1) // 2 * upperk):
        r += 1
    n = stage - (r + r * (r - 1) // 2 * upperk)
    m = (n + upperk - 1) // upperk
    log_dist = r - m
    slope = 0 if n == 0 else ((n - 1) % upperk) + 1
    return m, log_dist, slope


def num_stages(k: int, M: int) -> int:
    """Sorter.cpp:298: M + M(M-1)/2 * ceil(k/2)."""
    return M + M * (M - 1) // 2 * ((k + 1) // 2)


def gen_indices(num_slots: int, k: int, M: int, m: int, log_dist: int,
                slope: int) -> np.ndarray:
    """Masking.cpp:49-144: [2, num_slots] slot labels."""
    res = np.zeros((2, num_slots), dtype=np.int64)
    km = k ** m
    dist = k ** log_dist
    nxt = k ** (m + 1)
    total = k ** M

    def diagonal(start, row0, col0, d):
        row, col, loc = row0, col0, 1
        while row < km and col >= 0:
            here = start + dist * (col + k * row) + d
            res[0, here] = loc
            if row == km - 1 or col - slope < 0:
                for i in range(loc):
                    row_new = row - i
                    col_new = col + i * slope
                    here_new = start + dist * (col_new + k * row_new) + d
                    res[1, here_new] = loc - i
                    res[0, here_new] += i
            loc += 1
            row += 1
            col -= slope

    for start in range(0, total, dist * nxt):
        if slope == 0:
            for s in range(km):
                loc = 1
                row, col = s, 0
                while row >= 0 and col < k:
                    for d in range(dist):
                        here = start + dist * (row + km * col) + d
                        res[0, here] = k
                        res[1, here] = loc
                    loc += 1
                    col += 1
        elif slope > k // 2:
            for t in range(km - 1):
                col = k - k // 2
                for loc in range(1, k):
                    for d in range(dist):
                        here = start + dist * (col + k * t + loc - 1) + d
                        res[0, here] = k - 1
                        res[1, here] = loc
        else:
            for t in range(slope, k):
                for d in range(dist):
                    diagonal(start, 0, t, d)
            for s in range(1, km - 1):
                for t in range(k - slope, k):
                    for d in range(dist):
                        diagonal(start, s, t, d)
    return res


def gen_mask(indices: np.ndarray, index0: int, index1: int) -> np.ndarray:
    """Masking.cpp:146-156."""
    return ((indices[0] == index0) & (indices[1] == index1)).astype(np.float64)


def get_rotate_distance(k: int, log_dist: int, slope: int) -> int:
    """Masking.cpp:158-167."""
    dist = k ** log_dist
    if slope == 0 or slope == k // 2 + 1:
        return dist
    return dist * (k - slope)
