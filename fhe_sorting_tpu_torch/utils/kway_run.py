"""The k-way sorting network at ring 2^17 under a uniform ternary secret, with
real bootstraps, in one process.

    python -m fhe_sorting_tpu_torch.utils.kway_run --n 16 [--trials 1]

The configuration is the reference's own k-way deployment
(kway_adapter.h:41-64, KWaySort235Test.cpp:98-222): k=2, ring 2^17, a
uniform ternary secret, the 128-bit logQP budget and real CKKS bootstraps
mid-sort.  The chain is depth 42 (the reference's 40 plus two levels: the
uniform refresh takes about 24 levels and a k=2 stage about 18), scale 2^56
from prime pairs (comp=2), a 30-bit first modulus and dnum=3, on the
butterfly NTT.  The refresh is the uniform-secret shape: K=512, degree 270,
four double-angle steps, two arcsine terms, level budget (3,3), every
rotation through a RotationComposer over the signed power-of-two basis with
a lazy key pool of 6.  CompositeSign(3,3,2) (`KWAY_CONFIG[16]`) with
`mult_depth` set to the chain's depth, so the sign layer refreshes
mid-compare.  The input is `rng(0).permutation(N)/N + 0.5/N`.

Prints the card, logQP against the budget, the device memory reckoned before
allocating, setup seconds, each bootstrap's level and seconds, each sort's
seconds, rotations, lazy keygens and plaintext-memo hits and misses, the
peak device memory and the max error against np.sort; exits non-zero on an
error >= 0.01, on logQP over the budget, where no bootstrap fired, or where
the peak device memory exceeds the budget `check_phase` reckoned with.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import hbm_budget

RING = 1 << 17
DEPTH = 42
LOGQP_128 = {1 << 17: 3524}      # HEStd_128_classic, ternary secret
LAZY_KEYS = 6
BOOT_SHAPE = dict(K=512.0, sin_degree=270, double_angle=4, asin_terms=2)


@dataclass
class KwayRun:
    """What `build` made: the context and keys, the evaluator, the composer
    and bootstrapper, the k=2 sorter, the sign config and the input.  The
    sorter's bootstrap hook appends one record a refresh to `fired`: the
    input level, the seconds, the lazy keygens and the plaintext-memo misses
    and hits."""

    ctx: object
    keys: object
    ev: object
    rot: object
    bs: object
    sorter: object
    cfg: object
    vals: np.ndarray
    logqp: float
    report: dict
    memo: str
    fired: list = field(default_factory=list)


def refresh_plaintext_bytes(ctx, bs) -> int:
    """An upper bound on one refresh's encoded plaintexts: every C2S and S2C
    diagonal and the two slot masks, each at the whole chain's limbs."""
    count = sum(len(lt.diags) for lt in bs.c2s) + sum(len(g) for g in bs._s2c_groups) + 2
    return count * ctx.num_q * ctx.params.ring_n * 8


def build(n: int = 16, ring: int = RING, device=None,
          capacity_gb: float | None = None) -> KwayRun:
    """The configuration of the module docstring, at `ring` on `device`
    (None: the first CUDA card; `capacity_gb` stands in for the device's
    memory where it cannot be read)."""
    from ..core.bootstrap import Bootstrapper
    from ..core.context import CkksParams, Context
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..models.kway.sorter import KWaySorter, rotation_indices_kway
    from ..ops.rotation import RotationComposer
    from ..ops.sign import CompositeSignConfig, SignConfig
    from .params_registry import KWAY_CONFIG

    k, M, df, dg = KWAY_CONFIG[n]
    if k != 2:
        raise ValueError(f"N={n}: the configuration is the k=2 network, N a power of two")
    # no secret_hamming: a uniform ternary secret
    ctx = Context(CkksParams(ring_n=ring, mult_depth=DEPTH, scale_bits=56, comp=2,
                             base_limbs=4, first_mod_bits=30, dnum=3, ntt_impl="butterfly"),
                  device=device)
    logqp = sum(math.log2(p) for p in ctx.all_primes)
    if ring in LOGQP_128 and logqp > LOGQP_128[ring]:
        raise ValueError(f"logQP {logqp:.1f} exceeds the 128-bit budget {LOGQP_128[ring]}")
    # the basis: positive powers of two (the refresh's giant steps decompose
    # over it or take a lazy key) and the sorter's small negative steps
    basis = sorted({1 << i for i in range(ring.bit_length() - 2)} | {-(1 << i) for i in range(4)})
    steps = sorted(set(basis) | rotation_indices_kway(1 << (n - 1).bit_length()))
    # resident: the rotation keys, the conjugation key, the lazy pool; the
    # network's ciphertexts and a refresh's working set (measured on this
    # configuration; `chip_smoke.py` phase 11 prints the peak beside it)
    report = hbm_budget.check_phase(ctx, len(steps) + 1 + LAZY_KEYS,
                                    8 + hbm_budget.WORK_CTS["bootstrap"],
                                    capacity_gb=capacity_gb, label=f"k-way N={n}")
    keys = Keys.generate(ctx, seed=0)
    keys.gen_conj_key()
    ev = Evaluator(ctx, keys)
    rot = RotationComposer(ev, basis, lazy_key_budget=LAZY_KEYS)
    bs = Bootstrapper(ev, level_budget=(3, 3), rot=rot, **BOOT_SHAPE)
    keys.gen_rotation_keys(steps)
    # the plaintext memo: one refresh's diagonals where the room the
    # reckoning leaves holds their bound (every later refresh then encodes
    # nothing), else the evaluator's default, a fraction of them, so that
    # every refresh encodes them all again.  A memo between the two would
    # hold no more than the default: an LRU smaller than the refresh's cycle
    # of plaintexts evicts each one before its next use.
    need = refresh_plaintext_bytes(ctx, bs)
    room = (report["budget_gib"] - report["used_gib"]) * (1 << 30)
    if need <= room:
        ev.pt_cache_bytes = need
        memo = (f"{need / 2**30:.2f} GiB (one refresh's diagonals at the whole chain's limbs; "
                f"{room / 2**30:.2f} GiB of room left by the reckoning)")
    else:
        memo = (f"the default {ev.pt_cache_bytes / 2**30:.2f} GiB (one refresh needs up to "
                f"{need / 2**30:.2f} GiB, the reckoning leaves {room / 2**30:.2f} GiB)")
    run = KwayRun(ctx=ctx, keys=keys, ev=ev, rot=rot, bs=bs, sorter=None,
                  cfg=SignConfig(CompositeSignConfig(3, dg, df), mult_depth=DEPTH),
                  vals=np.random.default_rng(0).permutation(n) / n + 0.5 / n,
                  logqp=logqp, report=report, memo=memo)

    def bootstrap_fn(ct):
        lazy0, pt0 = rot.stats.lazy_keygens, dict(ev.pt_stats)
        t0 = time.time()
        out = bs.bootstrap(ct)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        run.fired.append(dict(level=ct.level, s=time.time() - t0,
                              lazy_keygens=rot.stats.lazy_keygens - lazy0,
                              memo_misses=ev.pt_stats["misses"] - pt0["misses"],
                              memo_hits=ev.pt_stats["hits"] - pt0["hits"]))
        return out

    run.sorter = KWaySorter(ev, k, M, bootstrap_fn=bootstrap_fn, rot=rot)
    return run


def describe(fired) -> str:
    """One (level, seconds, lazy keygens, memo misses) group a refresh."""
    return ", ".join(f"({f['level']}, {f['s']:.2f}, {f['lazy_keygens']}, {f['memo_misses']})"
                     for f in fired)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--trials", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kway_run: no CUDA device")
    from ..ops.sign import SignFunc
    from .profile_sort import card

    smi = card()
    print(smi)
    t0 = time.time()
    run = build(args.n)
    torch.cuda.synchronize()
    budget = LOGQP_128[RING]
    print(f"# k-way N={args.n}: ring 2^17, depth {DEPTH}, Lq={run.ctx.num_q}, K={run.ctx.num_sp}, "
          f"uniform ternary secret, logQP {run.logqp:.1f} against the 128-bit budget {budget}; "
          f"reckoned before allocating: {run.report}; plaintext memo {run.memo}; setup "
          f"{time.time() - t0:.1f}s ({len(run.keys.rot)} keys resident + lazy pool {LAZY_KEYS})")
    ok = True
    expected = np.sort(run.vals)
    for trial in range(max(1, args.trials)):
        run.fired.clear()
        stats0 = (run.rot.stats.rotations, run.rot.stats.composed, run.rot.stats.lazy_keygens)
        pt0 = dict(run.ev.pt_stats)
        ct = run.keys.encrypt(run.vals, slots=args.n)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = run.sorter.sort(ct, SignFunc.CompositeSign, run.cfg)
        torch.cuda.synchronize()
        secs = time.time() - t0
        err = float(np.abs(run.keys.decrypt(out, args.n) - expected).max())
        rots, composed, lazy = (a - b for a, b in zip(
            (run.rot.stats.rotations, run.rot.stats.composed, run.rot.stats.lazy_keygens), stats0))
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"# trial {trial}: sort {secs:.2f}s, {len(run.fired)} bootstraps (level, s, lazy "
              f"keygens, memo misses): {describe(run.fired)}; output level {out.level}; "
              f"rotations {rots}, composed {composed}, lazy keygens {lazy}; plaintext memo "
              f"{run.ev.pt_stats['misses'] - pt0['misses']} misses, "
              f"{run.ev.pt_stats['hits'] - pt0['hits']} hits, "
              f"{run.ev._pt_cache_used / 2**30:.2f} GiB held; peak device memory {peak:.2f} GiB "
              f"measured against the {run.report['budget_gib']} GiB budget, "
              f"{run.report['used_gib']} GiB reckoned for keys, ciphertexts and a refresh; max "
              f"error {err:.3e} ({smi})")
        hbm_budget.check_peak(run.report, peak)
        ok = ok and err < 0.01 and len(run.fired) >= 1
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
