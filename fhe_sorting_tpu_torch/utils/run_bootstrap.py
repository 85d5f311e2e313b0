"""One bootstrap at full slot packing: its error, levels and seconds as a row.

    python -m fhe_sorting_tpu_torch.utils.run_bootstrap [--ring 16384] [--budget 3]
        [--depth 30] [--uniform] [--sin-degree D] [--asin-terms 3] [--device cpu]
        [--out experiment_results_torch/bootstrap/level_budgets.json]

Port of `benchmarks/run_bootstrap.py`: the same chain (scale 2^56 from
prime pairs, the bottom pair near 2^30 for ModRaise), the same EvalMod shape
per ring and secret (`shape`), the same composer basis with a lazy key pool,
the same input (`rng(3).uniform(0, 1, ring // 2)`), the same timed window
(the reduction to level 8 and the refresh), and the same row keys, `bootstrap_s_gpu` on the card and `bootstrap_s_cpu` on
the CPU.  The row is printed and appended to `--out`.  The NTT is the
context's default (`ntt_impl="auto"`: K1 on the card at ring 2^14 and up)
unless `FHE_NTT` names another.  On the card the device memory is reckoned
before anything is allocated (`reckon`) and the measured peak is held to
it; `#` lines on stderr give the card, the NTT and the kernels' launches in
the refresh.

`context`, `reckon` and `assemble` also build `chip_smoke.py`'s bootstraps
(phases 8 and 9).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

LAZY_KEY_BUDGET = 8
# the sparse test secret's ones (without --uniform)
HAMMING = 64


def shape(ring: int, uniform: bool, sin_degree: int | None = None, asin_terms: int = 3) -> dict:
    """The EvalMod shape (`Bootstrapper` arguments) for a ring and secret.

    Uniform ternary secret: K about 6 sigma of the q0-multiple I (sigma about
    sqrt(h/12), h about 2n/3), and double-angle steps that keep the fitted
    range K / 2^r at 32.  Sparse secret (hamming 64): K = 13, two double-angle
    steps (the cosine seed and the arcsine in y)."""
    if uniform:
        K = {4096: 128.0, 8192: 128.0, 16384: 256.0, 32768: 256.0,
             65536: 512.0}.get(ring, 512.0)
        return dict(K=K, sin_degree=sin_degree or 270, double_angle=int(np.log2(K)) - 5,
                    asin_terms=asin_terms)
    return dict(K=13.0, sin_degree=sin_degree or 64, double_angle=2, asin_terms=asin_terms)


def basis(ring: int) -> list:
    """The composer's directly keyed steps: the powers of two below ring / 2."""
    return sorted({1 << i for i in range(ring.bit_length() - 2)})


def context(ring: int, depth: int, hamming: int | None, ntt_impl: str = "auto", device=None):
    """The bootstrap's chain: comp 2 at scale 2^56, the bottom pair of
    primes near 2^30 (q0 / Delta = 16), a sparse secret of `hamming` ones or
    a uniform ternary one (None)."""
    from ..core.context import CkksParams, Context

    return Context(CkksParams(ring_n=ring, mult_depth=depth, scale_bits=56, comp=2,
                              base_limbs=4, first_mod_bits=30, secret_hamming=hamming,
                              ntt_impl=ntt_impl), device=device)


def reckon(ctx, label: str, pt_cache_bytes: int | None = None, n_cts: int = 4) -> dict:
    """`hbm_budget.check_phase` of a bootstrap on `ctx`: resident the basis,
    the conjugation key and the lazy pool, `n_cts` ciphertexts and the
    plaintext memo at its bound (None: the evaluator's default), beside a
    refresh's working set (`WORK_CTS["bootstrap"]`)."""
    from ..core.evaluator import _PT_CACHE_BYTES
    from . import hbm_budget

    memo = pt_cache_bytes or _PT_CACHE_BYTES
    return hbm_budget.check_phase(ctx, len(basis(ctx.params.ring_n)) + 1 + LAZY_KEY_BUDGET,
                                  n_cts + -(-memo // hbm_budget.ct_bytes(ctx, 0)),
                                  work_cts=hbm_budget.WORK_CTS["bootstrap"], label=label)


def assemble(ctx, level_budget: tuple, shp: dict, pt_cache_bytes: int | None = None):
    """(keys, evaluator, composer, Bootstrapper) on `ctx`: keys from seed 0,
    the conjugation key, the basis keys; every rotation of the transforms
    through a RotationComposer with a lazy key pool.  `pt_cache_bytes` bounds
    the evaluator's plaintext memo (None: its default)."""
    from ..core.bootstrap import Bootstrapper
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..ops.rotation import RotationComposer

    keys = Keys.generate(ctx, seed=0)
    keys.gen_conj_key()
    ev = Evaluator(ctx, keys, **({} if pt_cache_bytes is None else
                                 {"pt_cache_bytes": pt_cache_bytes}))
    steps = basis(ctx.params.ring_n)
    rot = RotationComposer(ev, steps, lazy_key_budget=LAZY_KEY_BUDGET)
    bs = Bootstrapper(ev, level_budget=level_budget, rot=rot, **shp)
    keys.gen_rotation_keys(steps)
    return keys, ev, rot, bs


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ring", type=int, default=16384)
    ap.add_argument("--budget", type=int, default=3)
    ap.add_argument("--depth", type=int, default=30)
    ap.add_argument("--uniform", action="store_true",
                    help="uniform ternary secret (double-angle EvalMod); "
                         "default: sparse hamming-64 test secret, K=13")
    ap.add_argument("--sin-degree", type=int, default=None)
    ap.add_argument("--asin-terms", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--out", default="experiment_results_torch/bootstrap/level_budgets.json")
    return ap


def harness_context(args):
    """The context of a run with the parsed `args`."""
    return context(args.ring, args.depth, None if args.uniform else HAMMING, device=args.device)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)

    from ..core import bf_ntt, fs_ntt
    from ..core.ntt import synchronize
    from . import hbm_budget

    ring, lb = args.ring, args.budget
    t0 = time.time()
    ctx = harness_context(args)
    on_card = ctx.device.type == "cuda"
    if on_card:
        from .profile_sort import card

        where = card()
        report = reckon(ctx, f"bootstrap ring {ring}")
        _log(f"# reckoned before allocating: {report}")
        torch.cuda.reset_peak_memory_stats(ctx.device)
    else:
        where = str(ctx.device)
    logqp = sum(math.log2(p) for p in ctx.all_primes)
    _log(f"# device {where}; NTT {ctx.ntt_impl}; depth {args.depth}, Lq={ctx.num_q}, "
         f"K={ctx.num_sp}, logQP {logqp:.0f}")
    shp = shape(ring, args.uniform, args.sin_degree, args.asin_terms)
    keys, ev, rot, bs = assemble(ctx, (lb, lb), shp)
    synchronize(ctx.device)
    setup_s = time.time() - t0
    _log(f"# setup {setup_s:.1f}s ({len(keys.rot)} direct keys)")

    nh = ring // 2
    z = np.random.default_rng(3).uniform(0, 1.0, nh)
    ct = keys.encrypt(z)
    fs_ntt.launches = bf_ntt.launches = 0
    t0 = time.time()
    out = bs.bootstrap(ev.level_reduce(ct, 8))
    synchronize(ctx.device)
    boot_s = time.time() - t0
    _log(f"# launches in the refresh: K1 {fs_ntt.launches}, K2 {bf_ntt.launches}; "
         f"{boot_s:.2f}s ({where})")
    if on_card:
        peak = torch.cuda.max_memory_allocated(ctx.device) / 2**30
        _log(f"# peak device memory {peak:.2f} GiB measured, {report['used_gib']} GiB reckoned, "
             f"budget {report['budget_gib']} GiB")
        hbm_budget.check_peak(report, peak)
    err = np.abs(keys.decrypt(out, nh) - z)
    K, deg, da = shp["K"], shp["sin_degree"], shp["double_angle"]
    row = {
        "ring": ring, "level_budget": [lb, lb], "slots": nh,
        "max_err": float(err.max()), "mean_err": float(err.mean()),
        "levels_consumed": out.level, "out_level": out.level,
        "setup_s": round(setup_s, 1),
        f"bootstrap_s_{'gpu' if on_card else 'cpu'}": round(boot_s, 1),
        "secret": "uniform_ternary" if args.uniform else "hamming64",
        "chain": (f"comp=2 Delta=2^56, q0/Delta=16, K={K:.0f}, "
                  f"sin_degree={deg}, double_angle={da}, "
                  f"asin_terms={args.asin_terms}, composed-key basis "
                  f"({len(basis(ring))} direct + lazy pool)"),
    }
    print(json.dumps(row), flush=True)
    rows = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            rows = json.load(f)
    rows.append(row)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return row


if __name__ == "__main__":
    main()
