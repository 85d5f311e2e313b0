"""The traffic generator: one data owner's sort requests, drawn from the seed.

A client sends its next sort when the last one has returned (a closed loop
of one client).  A traffic mix is a data file `traffic/<name>.json` of
parameters:

  pool          how many input vectors are encrypted in set-up and then
                sorted back to back, cycling through them
  warmup_sorts  sorts in set-up before the window (the first captures the
                stages; the next ones replay them)
  traced_sorts  sorts of the window that a `--trace 1` run profiles

and, where the mix sets them, where the offsets below lie (defaults in
brackets):

  offset_width  the width of the offsets' range, centred in [0, 1] [0.5],
                above 0 and at most 1
  offset_edge   the share of each stratum kept free at either edge [0.2],
                above 0 and below 0.5

Pool vector j holds the n values (k + o_j) / n, k = 0..n-1, in an order
drawn from the seed, so every value lies in (0, 1), the gap between
neighbours is 1/n (the sorts' input contract) and no two values tie (the
rank sort breaks no ties).  Its offset o_j is drawn from the seed in the
j-th of `pool` equal strata of [(1 - offset_width) / 2, (1 + offset_width) / 2],
away from the strata's edges, so the sorted answers of two pool vectors
differ in every slot by at least `answer_gap(traffic, n)`: an answer to one
request is never taken for the answer to another.  A mix whose limit is
wide (a sort with refreshes) widens the offsets' range and edge to keep its
answers that far apart.  The work is the same for every seed.

Every stream is derived from the seed and a stream number, so the secret,
the key randomness, the values and the encryption noise are independent
and the same seed gives the same run inputs.
"""

from __future__ import annotations

import numpy as np

SECRET, KEYS, VALUES, ENCRYPT = range(4)
SORTS = ("pool", "warmup_sorts", "traced_sorts")
OFFSETS = {"offset_width": 0.5, "offset_edge": 0.2}


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, stream]))


def check(traffic: dict) -> None:
    if not set(SORTS) <= set(traffic) <= set(SORTS) | set(OFFSETS):
        raise ValueError(f"traffic: the keys are {', '.join(SORTS)} and optionally "
                         f"{', '.join(OFFSETS)}; got {sorted(traffic)}")
    if min(traffic[k] for k in SORTS) < 1:
        raise ValueError("traffic: pool, warmup_sorts and traced_sorts must be at least 1")
    width, edge = offsets(traffic)
    if not (0 < width <= 1 and 0 < edge < 0.5):
        raise ValueError("traffic: 0 < offset_width <= 1 and 0 < offset_edge < 0.5; "
                         f"got {width}, {edge}")


def offsets(traffic: dict) -> tuple:
    """(offset_width, offset_edge) of the mix, defaults where unset."""
    return tuple(traffic.get(k, v) for k, v in OFFSETS.items())


def secret(ring_n: int, seed: int) -> np.ndarray:
    """The uniform ternary secret's coefficients [ring_n] in {-1, 0, 1}."""
    return rng(seed, SECRET).integers(-1, 2, size=ring_n).astype(np.int64)


def answer_gap(traffic: dict, n: int) -> float:
    """The least difference, in every slot, between two pool vectors' sorted answers."""
    width, edge = offsets(traffic)
    return 2 * edge * width / traffic["pool"] / n


def vectors(traffic: dict, n: int, seed: int) -> list:
    """The pool of input vectors, each of n values."""
    check(traffic)
    width, edge = offsets(traffic)
    r = rng(seed, VALUES)
    pool = traffic["pool"]
    low = (1 - width) / 2
    drawn = low + width * (np.arange(pool) + r.uniform(edge, 1 - edge, size=pool)) / pool
    return [r.permutation((np.arange(n) + o) / n) for o in drawn]


def encryption_seeds(traffic: dict, seed: int) -> list:
    return [int(s) for s in rng(seed, ENCRYPT).integers(0, 2**63, size=traffic["pool"])]
