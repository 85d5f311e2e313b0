"""precision_bits: -log2 of the largest absolute error of any slot of any timed sort's output against np.sort of its input."""

import math


def read(run):
    if not run.errors:
        return None
    worst = max(run.errors)
    return -math.log2(worst) if 0 < worst < math.inf else None
