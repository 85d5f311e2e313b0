"""The traffic generator: one data owner's sort requests, drawn from the seed.

A client sends its next sort when the last one has returned (a closed loop
of one client).  A traffic mix is a data file `traffic/<name>.json` of
parameters:

  pool          how many input vectors are encrypted in set-up and then
                sorted back to back, cycling through them
  warmup_sorts  sorts in set-up before the window (the first captures the
                stages; the next ones replay them)
  traced_sorts  sorts of the window that a `--trace 1` run profiles

Pool vector j holds the n values (k + o_j) / n, k = 0..n-1, in an order
drawn from the seed, so every value lies in (0, 1), the gap between
neighbours is 1/n (the sorts' input contract) and no two values tie (the
rank sort breaks no ties).  Its offset o_j is drawn from the seed in the
j-th of `pool` equal strata of [0.25, 0.75], away from the strata's edges,
so the sorted answers of two pool vectors differ in every slot by at least
`answer_gap(pool, n)`: an answer to one request is never taken for the
answer to another.  The work is the same for every seed.

Every stream is derived from the seed and a stream number, so the secret,
the key randomness, the values and the encryption noise are independent
and the same seed gives the same run inputs.
"""

from __future__ import annotations

import numpy as np

SECRET, KEYS, VALUES, ENCRYPT = range(4)
LOW, WIDTH, EDGE = 0.25, 0.5, 0.2     # offsets in [LOW, LOW + WIDTH], EDGE of a stratum kept free


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, stream]))


def check(traffic: dict) -> None:
    if set(traffic) != {"pool", "warmup_sorts", "traced_sorts"}:
        raise ValueError(f"traffic: the keys are pool, warmup_sorts, traced_sorts; got {sorted(traffic)}")
    if min(traffic.values()) < 1:
        raise ValueError("traffic: pool, warmup_sorts and traced_sorts must be at least 1")


def secret(ring_n: int, seed: int) -> np.ndarray:
    """The uniform ternary secret's coefficients [ring_n] in {-1, 0, 1}."""
    return rng(seed, SECRET).integers(-1, 2, size=ring_n).astype(np.int64)


def answer_gap(pool: int, n: int) -> float:
    """The least difference, in every slot, between two pool vectors' sorted answers."""
    return 2 * EDGE * WIDTH / pool / n


def vectors(traffic: dict, n: int, seed: int) -> list:
    """The pool of input vectors, each of n values."""
    check(traffic)
    r = rng(seed, VALUES)
    pool = traffic["pool"]
    offsets = LOW + WIDTH * (np.arange(pool) + r.uniform(EDGE, 1 - EDGE, size=pool)) / pool
    return [r.permutation((np.arange(n) + o) / n) for o in offsets]


def encryption_seeds(traffic: dict, seed: int) -> list:
    return [int(s) for s in rng(seed, ENCRYPT).integers(0, 2**63, size=traffic["pool"])]
