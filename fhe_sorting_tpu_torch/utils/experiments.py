"""Multi-trial experiment harness with per-size aggregation; the port of
`benchmarks/run_experiments.py` and `benchmarks/aggregate.py`.

    python -m fhe_sorting_tpu_torch.utils.experiments --algo direct \\
        --sizes 4 8 16 --trials 3 --ring 4096 [--device cpu] \\
        [--out experiment_results_torch/direct] [--subprocess-per-N]
    python -m fhe_sorting_tpu_torch.utils.experiments --aggregate DIR [--algo A]

Every size first runs one warm-up sort (kernel builds and memo fills,
reported as `warmup_s`), then `--trials` timed sorts, each ending in a
device synchronise, whose mean is `mean_time_s`.  The inputs are
`vector_with_min_diff(N, seed)` (the warm-up seed 0, trial t seed t).  Each
size writes `N<k>_summary.txt` into `--out`, and the run `total_results.txt`:
the JAX package's row schema (N, trials, mean_time_s, warmup_s,
max_err_log2, avg_err_log2, config); the row's `config` also names the
device.  `--subprocess-per-N` runs each size in a process of its own.
`--aggregate DIR` rebuilds `total_results.txt` from the summaries in DIR.

The configurations are those of the JAX package's `run_experiments.py`:
`direct` and `mehp24` on a deep chain without bootstrapping (DirectSort's
depth from the depth meter, MEHP24's from the registry plus 2); `kway` (the
reference's deployment, depth 40 with real bootstraps, the registry's per-N
(k, M, d_f, d_g)) and `bitonic` (depth 40, bootstraps below level 20), both
under a sparse secret (hamming 64) with a budget-(2, 2) bootstrap.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

ALGOS = ("direct", "mehp24", "kway", "bitonic")


def vector_with_min_diff(n: int, min_v: float = 0.0, max_v: float = 1.0,
                         min_diff: float | None = None, seed: int = 0) -> np.ndarray:
    """Shuffled uniform grid with a guaranteed minimum gap (the reference's
    tests/utils.h:7-51): the gap of about 1/N is what the sign configuration
    must resolve."""
    if min_diff is None:
        min_diff = (max_v - min_v) / n
    rng = np.random.default_rng(seed)
    max_steps = int((max_v - min_v) / min_diff)
    assert max_steps >= n
    steps = rng.choice(max_steps, size=n, replace=False)
    vals = min_v + steps * min_diff
    rng.shuffle(vals)
    return vals.astype(np.float64)


def _pow2_steps(ring: int, negative: bool = False) -> set:
    pos = {1 << i for i in range(ring.bit_length() - 2)}
    return pos | ({-s for s in pos} if negative else set())


def _bootstrap_env(ring: int, depth: int, device):
    """The sparse-secret bootstrapping configuration of the kway and bitonic
    rows: comp=2 from 30-bit bottom primes, a budget-(2, 2) bootstrap, its
    BSGS rotations and the power-of-two steps both ways."""
    from ..core.bootstrap import Bootstrapper
    from ..core.context import CkksParams, Context
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys

    ctx = Context(CkksParams(ring_n=ring, mult_depth=depth, scale_bits=56, comp=2,
                             base_limbs=4, secret_hamming=64, first_mod_bits=30),
                  device=device)
    keys = Keys.generate(ctx, seed=0)
    keys.gen_conj_key()
    ev = Evaluator(ctx, keys)
    bs = Bootstrapper(ev, K=13.0, sin_degree=255, level_budget=(2, 2), asin_terms=2)
    keys.gen_rotation_keys(sorted(bs.required_rotations() | _pow2_steps(ring, negative=True)))
    return keys, ev, bs


def build_sorter(algo: str, N: int, ring: int, depth: int | None, dg: int | None,
                 df: int | None, comp: int, device=None):
    """Returns (keys, sorter, cfg, encrypt_fn, info) for one size."""
    from ..core.context import CkksParams, Context
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..ops.sign import CompositeSignConfig, SignConfig
    from .params_registry import KWAY_CONFIG, KWAY_MULT_DEPTH, MEHP24_DEPTH, direct_sort_sign_cfg

    if algo == "kway":
        from ..models.kway.adapter import KWayAdapter, kway_decompose

        k, M = kway_decompose(N)
        c_df, c_dg = 2, 2
        if N in KWAY_CONFIG:
            k, M, c_df, c_dg = KWAY_CONFIG[N]
        dg = dg if dg is not None else c_dg
        df = df if df is not None else c_df
        depth = depth or KWAY_MULT_DEPTH
        keys, ev, bs = _bootstrap_env(ring, depth, device)
        fired = []

        def bfn(ct):
            fired.append(ct.level)
            return bs.bootstrap(ct)

        sorter = KWayAdapter(ev, N, bootstrap_fn=bfn)
        cfg = SignConfig(CompositeSignConfig(3, dg, df), mult_depth=depth)
        slots = 1 << (N - 1).bit_length()

        def enc(x):
            padded = np.zeros(slots)
            padded[:N] = x
            return keys.encrypt(padded, slots=slots)

        info = {"k": k, "M": M, "dg": dg, "df": df, "mult_depth": depth,
                "bootstrap_level_budget": [2, 2], "bootstraps_fired": fired}
        return keys, sorter, cfg, enc, info

    if algo == "bitonic":
        from ..models.bitonic import BitonicSort

        dg = dg if dg is not None else 2
        df = df if df is not None else 2
        depth = depth or 40
        keys, ev, bs = _bootstrap_env(ring, depth, device)
        fired = []

        def bfn(ct):
            fired.append(ct.level)
            return bs.bootstrap(ct, msg_scale_down=2.0)

        # refresh threshold 20: the budget-(2, 2) bootstrap lands near level
        # 19, and one compare stage costs at most 15 levels, so 20 + 15 stays
        # inside depth 40
        sorter = BitonicSort(ev, N, normalize=1.0, bootstrap_fn=bfn, bootstrap_level=20)
        cfg = SignConfig(CompositeSignConfig(3, dg, df), mult_depth=depth)

        def enc(x):
            return keys.encrypt(x, slots=N)

        info = {"dg": dg, "df": df, "mult_depth": depth, "bootstrap_level_budget": [2, 2],
                "bootstraps_fired": fired}
        return keys, sorter, cfg, enc, info

    if algo not in ("direct", "mehp24"):
        raise ValueError(algo)
    # direct / mehp24: a deep chain, no bootstrap
    if dg is None or df is None:
        _, rdg, rdf = direct_sort_sign_cfg(N)
        dg = dg if dg is not None else rdg
        df = df if df is not None else rdf
    if depth is None:
        if algo == "direct":
            from .depth_meter import measure_direct_sort_depth

            depth = measure_direct_sort_depth(N, ring, SignConfig(CompositeSignConfig(3, dg, df)),
                                              staged=False)["mult_depth"]
        else:
            # the registry's per-N depths (Mehp24SortTest.cpp:33-66) and a
            # margin for the stretched indicator's provisioning
            depth = MEHP24_DEPTH.get(N, 40) + 2
    ctx = Context(CkksParams(ring_n=ring, mult_depth=depth, scale_bits=56 if comp == 2 else 28,
                             comp=comp, base_limbs=4 if comp == 2 else 2), device=device)
    keys = Keys.generate(ctx, seed=0)
    cfg = SignConfig(CompositeSignConfig(3, dg, df))
    ev = Evaluator(ctx, keys)
    info = {"dg": dg, "df": df, "mult_depth": depth}
    if algo == "direct":
        from ..models.direct_sort import DirectSort, rotation_indices_direct_sort

        keys.gen_rotation_keys(sorted(rotation_indices_direct_sort(N, ring) | _pow2_steps(ring)))
        sorter = DirectSort(ev, N)

        def enc(x):
            return keys.encrypt(x)
    else:
        from ..models.mehp24 import Mehp24Sort
        from ..models.mehp24.utils import rotation_indices_mehp24

        sub = min(N, 256)
        keys.gen_rotation_keys(sorted(rotation_indices_mehp24(sub) | _pow2_steps(ring, negative=True)))
        sorter = Mehp24Sort(ev, N, sub_length=sub)
        info["sub_length"] = sub

        def enc(x):
            padded = np.zeros(sub * sub)
            padded[:N] = x
            return keys.encrypt(padded, slots=len(padded))
    return keys, sorter, cfg, enc, info


def run_size(algo: str, N: int, ring: int, depth: int | None, dg, df, comp: int, trials: int,
             device=None) -> dict:
    """One warm-up sort, then `trials` timed sorts; returns the summary row."""
    from ..core.ntt import device_name, synchronize
    from ..ops.sign import SignFunc

    keys, sorter, cfg, enc, info = build_sorter(algo, N, ring, depth, dg, df, comp, device)
    dev = keys.ctx.device

    def one(seed: int):
        x = vector_with_min_diff(N, seed=seed)
        ct = enc(x)
        t0 = time.perf_counter()
        out_ct = sorter.sort(ct, SignFunc.CompositeSign, cfg)
        synchronize(dev)
        dt = time.perf_counter() - t0
        errs = np.abs(keys.decrypt(out_ct, N) - np.sort(x))
        return dt, float(errs.max()), float(errs.mean())

    warm_s, wmax, wavg = one(seed=0)
    print(f"N={N} warm-up: {warm_s:.2f}s maxerr {wmax:.2e}", file=sys.stderr)
    rows = []
    for t in range(trials):
        dt, emax, eavg = one(seed=t)       # seed 0 repeats the warm-up's input
        rows.append((dt, emax, eavg))
        print(f"N={N} trial {t}: {dt:.2f}s maxerr {emax:.2e}", file=sys.stderr)
    memax = float(np.max([r[1] for r in rows] + [wmax]))
    meavg = float(np.mean([r[2] for r in rows] + [wavg]))
    if "bootstraps_fired" in info:
        info["bootstraps_fired"] = len(info["bootstraps_fired"]) // (trials + 1)
    info["device"] = device_name(dev)
    return {
        "N": N, "trials": trials,
        "mean_time_s": round(float(np.mean([r[0] for r in rows])), 3),
        "warmup_s": round(warm_s, 3),
        "max_err_log2": round(float(np.log2(max(memax, 1e-300))), 2),
        "avg_err_log2": round(float(np.log2(max(meavg, 1e-300))), 2),
        "config": info,
    }


def aggregate(directory: str, algo: str | None = None) -> dict:
    """Rebuild `total_results.txt` in `directory` from its N<k>_summary.txt
    files, sorted by N (the algorithm defaults to the directory's name)."""
    rows = []
    for f in glob.glob(os.path.join(directory, "N*_summary.txt")):
        with open(f) as fh:
            rows.append(json.load(fh))
    rows.sort(key=lambda r: r["N"])
    out = {"algo": algo or os.path.basename(os.path.normpath(directory)), "results": rows}
    with open(os.path.join(directory, "total_results.txt"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return out


def main(argv=None) -> list | dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--algo", default=None, choices=ALGOS, help="default: direct")
    ap.add_argument("--sizes", type=int, nargs="+", default=[4, 8])
    ap.add_argument("--trials", type=int, default=1)
    ap.add_argument("--ring", type=int, default=2048)
    ap.add_argument("--depth", type=int, default=None,
                    help="default: the depth meter (direct), the registry + 2 (mehp24), "
                         "40 with bootstrapping (kway, bitonic)")
    ap.add_argument("--dg", type=int, default=None, help="default: the registry's per N")
    ap.add_argument("--df", type=int, default=None)
    ap.add_argument("--comp", type=int, default=2,
                    help="primes per level (2: Delta = 2^56)")
    ap.add_argument("--out", default="experiment_results_torch")
    ap.add_argument("--device", default=None, help="default: the first CUDA card")
    ap.add_argument("--subprocess-per-N", action="store_true",
                    help="run each size in a fresh process")
    ap.add_argument("--aggregate", metavar="DIR", default=None,
                    help="only rebuild DIR/total_results.txt from its summaries")
    args = ap.parse_args(argv)
    if args.aggregate is not None:
        return aggregate(args.aggregate, args.algo)
    algo = args.algo or "direct"

    os.makedirs(args.out, exist_ok=True)
    total = []
    for N in args.sizes:
        if args.subprocess_per_N:
            cmd = [sys.executable, "-m", __spec__.name, "--algo", algo, "--sizes", str(N),
                   "--trials", str(args.trials), "--ring", str(args.ring),
                   "--comp", str(args.comp), "--out", args.out]
            for flag in ("depth", "dg", "df", "device"):
                v = getattr(args, flag)
                if v is not None:
                    cmd += [f"--{flag}", str(v)]
            # the package's own root, so that the child imports this copy
            root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
            res = subprocess.run(cmd, stdout=subprocess.PIPE, env=env, check=True)
            summary = json.loads(res.stdout.decode().strip().splitlines()[-1])[0]
        else:
            summary = run_size(algo, N, args.ring, args.depth, args.dg, args.df, args.comp,
                               args.trials, args.device)
            with open(os.path.join(args.out, f"N{N}_summary.txt"), "w") as f:
                json.dump(summary, f, indent=1)
        total.append(summary)
    with open(os.path.join(args.out, "total_results.txt"), "w") as f:
        json.dump({"algo": algo, "results": total}, f, indent=1)
    print(json.dumps(total))
    return total


if __name__ == "__main__":
    main()
