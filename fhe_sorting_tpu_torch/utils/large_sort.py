"""One DirectSort at a large N on the card, by either path, with its memory
reckoned first.

    python -m fhe_sorting_tpu_torch.utils.large_sort --n 1024 --path per_op
    python -m fhe_sorting_tpu_torch.utils.large_sort --n 1024 --path staged

`per_op` keys nothing up front and lets the sort's RotationComposer generate
each rotation key just in time on the device, at most 8 of them resident;
`staged` keys the minimal scan set.  The configuration is `profile_sort`'s
(ring 2^17, scale 2^56 with comp 2, the depth from the depth meter) on the
butterfly NTT.  Prints the card, the reckoned and the measured peak
memory, seconds of a warm-up sort and of a timed one, the lazy keygens and
the max error against np.sort; exits non-zero on an error >= 0.01.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

LAZY_KEY_BUDGET = 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--path", choices=("per_op", "staged"), default="per_op")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("large_sort: no CUDA device")

    from . import hbm_budget
    from .profile_sort import RING, card, rotation_steps, sort_context, sorter

    smi = card()
    print(smi)
    N, ring = args.n, RING
    t0 = time.time()
    ctx, cfg, depth = sort_context(N, args.path, "butterfly")
    resident = len(rotation_steps(N, args.path, LAZY_KEY_BUDGET)) or LAZY_KEY_BUDGET
    report = hbm_budget.check_phase(ctx, resident, 8, label=f"{args.path} DirectSort N={N}")
    print(f"# {args.path} DirectSort N={N}, ring {ring}, depth {depth}, Lq={ctx.num_q}, "
          f"K={ctx.num_sp}; reckoned before allocating: {report}")
    keys, sort, rot = sorter(ctx, cfg, N, args.path, LAZY_KEY_BUDGET)
    torch.cuda.synchronize()
    print(f"# context and keys ({len(keys.rot)} rotation + relin) {time.time() - t0:.1f}s")

    vals = np.random.default_rng(0).permutation(N) / N + 0.5 / N
    ct = keys.encrypt(vals)
    secs = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        lazy0 = rot.stats.lazy_keygens if rot else 0
        t0 = time.time()
        out = sort(ct)
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
    lazy = (rot.stats.lazy_keygens - lazy0) if rot else 0
    peak = torch.cuda.max_memory_allocated() / 2**30
    err = float(np.abs(keys.decrypt(out, N) - np.sort(vals)).max())
    print(f"# {args.path} DirectSort N={N}: warm-up {secs[0]:.2f}s, timed {secs[1]:.2f}s; "
          f"max error {err:.3e}; lazy keygens in the timed sort {lazy}; peak device memory "
          f"{peak:.2f} GiB measured, {report['used_gb']} GB reckoned ({smi})")
    return 0 if err < 0.01 else 1


if __name__ == "__main__":
    raise SystemExit(main())
