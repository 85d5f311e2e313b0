"""Rotation microbenchmark: chains of `rotate` against hoisted `rotate_hoisted`
over one shared precompute; the port of `benchmarks/rotation_bench.py`.

For each chain length c: c successive rotations by 1..c, and c hoisted
rotations of one ciphertext by 1..c (one ModUp shared), each after a warm-up
and averaged over `--reps`, every repetition ending in a device synchronise.
The automorphism is the evaluator's (the gather, or the affine path under
`FHE_AFFINE_AUTO`).

    python -m fhe_sorting_tpu_torch.utils.rotation_bench [--ring 4096]
        [--depth 4] [--chains 1 2 3 5 10] [--reps 10] [--device cpu]

The last line of standard output is one JSON object, the reference's
`{"metric": "rotate_chain_ms", "results": {...}, "ring": n}` and the device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> dict:
    from ..core.context import CkksParams, Context
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..core.ntt import device_name, synchronize

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ring", type=int, default=4096)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--chains", type=int, nargs="*", default=[1, 2, 3, 5, 10])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: the first CUDA card")
    args = ap.parse_args(argv)

    ctx = Context(CkksParams(ring_n=args.ring, mult_depth=args.depth), device=args.device)
    dev = ctx.device
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys(list(range(1, max(args.chains) + 1)))
    ev = Evaluator(ctx, keys)
    ct = keys.encrypt(np.arange(64) / 64.0)

    def chain(c):
        out = ct
        for r in range(1, c + 1):
            out = ev.rotate(out, r)
        return out

    def hoisted(c):
        pre = ev.rotate_precompute(ct)
        return [ev.rotate_hoisted(ct, pre, r) for r in range(1, c + 1)]

    def seconds(fn, c):
        fn(c)                      # warm-up
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn(c)
            synchronize(dev)
        return (time.perf_counter() - t0) / args.reps

    results = {}
    for c in args.chains:
        plain, hoist = seconds(chain, c), seconds(hoisted, c)
        results[c] = (plain, hoist)
        print(f"chain {c:3d}: rotate {plain * 1e3:8.2f} ms | hoisted {hoist * 1e3:8.2f} ms | "
              f"win {100 * (1 - hoist / max(plain, 1e-12)):5.1f}%", file=sys.stderr)
    out = {"metric": "rotate_chain_ms",
           "results": {str(k): {"plain_ms": round(v[0] * 1e3, 3), "hoisted_ms": round(v[1] * 1e3, 3)}
                       for k, v in results.items()},
           "ring": args.ring,
           "device": device_name(dev),
           "affine": ev.use_affine}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
