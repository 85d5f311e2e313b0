"""Decrypt-probe harness for DirectSort; the port of `benchmarks/probe_direct.py`.

Runs constructRank, decrypts and probes the rank error, runs
rotationIndexCheckN on the rank, and probes the sorted output, printing each
phase's seconds (ending in a device synchronise) and its error: the
reference's DebugEncryption workflow for finding where noise enters
(DirectSortNTest.cpp:130-285).

    python -m fhe_sorting_tpu_torch.utils.probe_direct --n 16 --ring 4096
        [--comp 2] [--depth auto] [--dnum 3] [--cn C --dg G --df F]
        [--device cpu]

Progress goes to standard error; the last line of standard output is one
JSON object with the errors, the seconds and the device.
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
    from ..models.direct_sort import DirectSort, rotation_indices_direct_sort
    from ..ops.sign import CompositeSignConfig, SignConfig, SignFunc
    from .depth_meter import measure_direct_sort_depth
    from .params_registry import direct_sort_sign_cfg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--ring", type=int, default=4096)
    ap.add_argument("--comp", type=int, default=2)
    ap.add_argument("--depth", type=int, default=None, help="default: the depth meter")
    ap.add_argument("--dnum", type=int, default=3)
    ap.add_argument("--cn", type=int, default=None)
    ap.add_argument("--dg", type=int, default=None)
    ap.add_argument("--df", type=int, default=None)
    ap.add_argument("--device", default=None, help="default: the first CUDA card")
    args = ap.parse_args(argv)

    cn, dg, df = direct_sort_sign_cfg(args.n)
    cn = args.cn if args.cn is not None else cn
    dg = args.dg if args.dg is not None else dg
    df = args.df if args.df is not None else df
    cfg = SignConfig(CompositeSignConfig(cn, dg, df))
    if args.depth is None:
        m = measure_direct_sort_depth(args.n, args.ring, cfg, staged=False)
        args.depth = m["mult_depth"]
        print(f"# depth meter: {m}", file=sys.stderr)

    t0 = time.perf_counter()
    ctx = Context(CkksParams(ring_n=args.ring, mult_depth=args.depth,
                             scale_bits=56 if args.comp == 2 else 28, comp=args.comp,
                             base_limbs=4 if args.comp == 2 else 2, dnum=args.dnum),
                  device=args.device)
    dev = ctx.device
    print(f"# context {time.perf_counter() - t0:.1f}s  ntt={ctx.ntt_impl}", file=sys.stderr)
    t0 = time.perf_counter()
    keys = Keys.generate(ctx, seed=0)
    steps = rotation_indices_direct_sort(args.n, args.ring)
    keys.gen_rotation_keys(sorted(steps))
    synchronize(dev)
    print(f"# keygen {time.perf_counter() - t0:.1f}s ({len(steps)} rot keys)", file=sys.stderr)
    srt = DirectSort(Evaluator(ctx, keys), args.n)
    print(f"# Lq={ctx.num_q} K={ctx.num_sp} sign=({cn},{dg},{df}) depth={args.depth}",
          file=sys.stderr)

    vals = np.random.default_rng(0).permutation(args.n) / args.n + 0.5 / args.n
    ct = keys.encrypt(vals)
    want_rank = np.array([np.sum(v > vals) for v in vals], dtype=np.float64)

    t0 = time.perf_counter()
    rank = srt.construct_rank(ct, SignFunc.CompositeSign, cfg)
    synchronize(dev)
    t_rank = time.perf_counter() - t0
    rank_err = np.abs(keys.decrypt(rank, args.n) - want_rank)
    print(f"# constructRank {t_rank:.2f}s  level={rank.level}  rank_err max={rank_err.max():.2e} "
          f"mean={rank_err.mean():.2e}", file=sys.stderr)

    t0 = time.perf_counter()
    out = srt.rotation_index_check_n(rank, ct)
    synchronize(dev)
    t_idx = time.perf_counter() - t0
    err = np.abs(keys.decrypt(out, args.n) - np.sort(vals))
    print(f"# rotationIndexCheckN {t_idx:.2f}s  level={out.level}  sort_err max={err.max():.2e} "
          f"mean={err.mean():.2e}", file=sys.stderr)
    res = {"n": args.n, "ring": args.ring, "comp": args.comp,
           "rank_err": float(rank_err.max()), "sort_err": float(err.max()),
           "t_rank_s": t_rank, "t_idx_s": t_idx,
           "device": device_name(dev)}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
