"""Sign-approximation characterizer.

Port of `fhe_sorting_tpu/utils/sign_characterizer.py` (the reference's
utils/sign_characterizer.cpp): sweep a CompositeSign configuration over
shrinking input magnitudes until the approximation error exceeds a
threshold; report the working precision, the depth consumed and the time.

  python -m fhe_sorting_tpu_torch.utils.sign_characterizer --configs 3,2,2 3,3,2

runs on the first CUDA card (`--device cpu` for the plain PyTorch NTTs) and
prints one JSON list, as the JAX package's characterizer does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def characterize(n: int, dg: int, df: int, ring: int = 1024, depth: int | None = None,
                 threshold: float = 0.01, device=None, keys=None):
    """Metrics of CompositeSign(n, dg, df).  The context is built at `ring`
    and `depth` (default: the iterations' levels + 4) on `device` (None: the
    first CUDA card) with keys from seed 0, unless `keys` is given: then
    its context and keys are used."""
    from ..core.context import CkksParams, Context
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..ops.sign import CompositeSignConfig, SignConfig, composite_sign

    if keys is None:
        per_iter = 3 if n == 3 else 5
        depth = depth or (dg + df) * per_iter + 4
        ctx = Context(CkksParams(ring_n=ring, mult_depth=depth), device=device)
        keys = Keys.generate(ctx, seed=0)
    ctx = keys.ctx
    ev = Evaluator(ctx, keys)
    cfg = SignConfig(CompositeSignConfig(n, dg, df))

    step = 0.5
    working = None
    elapsed = None
    consumed = None
    while step > 1e-9:
        vals = np.array([step, -step] * 32)
        ct = keys.encrypt(vals)
        t0 = time.time()
        out_ct = composite_sign(ev, ct, cfg)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        dt = time.time() - t0
        out = keys.decrypt(out_ct, 64)
        err = float(np.abs(out - np.sign(vals)).max())
        if err > threshold:
            break
        working = step
        elapsed = dt
        consumed = out_ct.level
        step /= 10.0
    return {
        "config": f"CompositeSign_{n}_{dg}_{df}",
        "working_precision": working,
        "depth_consumed": consumed,
        "time_s": round(elapsed, 3) if elapsed else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="+", default=["3,2,2", "3,3,2"], help="n,dg,df triples")
    ap.add_argument("--ring", type=int, default=1024)
    ap.add_argument("--device", default=None, help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    out = []
    for c in args.configs:
        n, dg, df = (int(v) for v in c.split(","))
        m = characterize(n, dg, df, ring=args.ring, device=args.device)
        print(m, file=sys.stderr)
        out.append(m)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
