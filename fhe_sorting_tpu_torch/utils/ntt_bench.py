"""NTT and key-switch microbenchmark: K2 and K1 against their plain versions.

    python -m fhe_sorting_tpu_torch.utils.ntt_bench [--ring 65536] [--limbs 40] [--iters 20]
        [--depth 34] [--device cpu]

Port of `benchmarks/ntt_bench.py`.  On int64 planes [2, limbs, ring] of
residues below the smallest of `primes.ntt_primes(ring, 28, limbs)` (the
reference's input, from `rng(0)`), times the forward and the inverse
transform of the plain butterfly, K2 (`core/bf_ntt.py`), the plain four-step
and K1 (`core/fs_ntt.py`), each line with its mean milliseconds over
`--iters` calls, the minimum-traffic rate (one read and one write of the
planes at 8 bytes a residue) and the share of the speed of light on
`roofline.H100` (`roofline.ntt_butterfly` / `ntt_fourstep`), each
direction followed by whether each of its transforms equals the plain
butterfly's, bit for bit.  Then one
rotation and one ct-ct multiplication on `Context(ring, depth)` (its default
NTT, or the one `FHE_NTT` names) against `roofline.keyswitch` / `ct_mult`.

On the card a kernel that fails raises.  On the CPU (`--device cpu`) the
kernel lines say they were not run, and no line gives a share of the card's
speed of light: a CPU time says nothing of it.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

NOT_RUN = "CUDA kernel: not run on the CPU"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ring", type=int, default=65536)
    ap.add_argument("--limbs", type=int, default=40)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--depth", type=int, default=34)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card; cpu runs the plain "
                         "versions only)")
    args = ap.parse_args(argv)

    from ..core import bf_ntt, fs_ntt, ntt_mxu
    from ..core import ntt as nttm
    from ..core.context import CkksParams, Context
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..core.primes import ntt_primes
    from . import roofline
    from .hbm_budget import RESIDUE_BYTES

    device = nttm.resolve_device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        from .profile_sort import card

        where = card()
        print(where)
    else:
        where = str(device)

    n, L = args.ring, args.limbs
    n1, n2 = ntt_mxu.split_n(n)
    primes = ntt_primes(n, 28, L)
    bf_t = nttm.build_device_tables(primes, n, device)
    fs_t = ntt_mxu.build_fs_tables(primes, n, device)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, min(primes), size=(2, L, n), dtype=np.uint32)
                         .astype(np.int64)).to(device)
    a4 = a.reshape(2, L, n1, n2)

    def share(cost, secs):
        if not on_card:
            return "share not measured on the CPU"
        return f"{cost.pct_of_sol(secs):.1f}%"

    def bench(name, fn, x, cost):
        """Mean seconds of fn(x) over --iters calls after one; None for a
        kernel on the CPU."""
        if fn is None:
            print(f"{name:24s} {NOT_RUN}")
            return None
        out = fn(x)
        nttm.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = fn(x)
        nttm.synchronize(device)
        dt = (time.perf_counter() - t0) / args.iters
        gb = 2 * x.numel() * RESIDUE_BYTES / 1e9
        print(f"{name:24s} {dt * 1e3:8.3f} ms   ({gb / dt:6.1f} GB/s min-traffic)   SoL "
              f"{cost.sol_seconds() * 1e3:.3f} ms ({cost.bound()}-bound) -> {share(cost, dt)} "
              f"({where})")
        return out.reshape(2, L, n)

    fs_cost = roofline.ntt_fourstep(n, L, polys=2)
    bf_cost = roofline.ntt_butterfly(n, L, polys=2)

    def transforms(inverse):
        """The four rows of one direction; their outputs as [2, L, n]."""
        kind = "intt" if inverse else "ntt"
        return (
            bench(f"{kind}/plain-butterfly",
                  lambda x: nttm.butterfly_plain(x, bf_t, None, inverse), a, bf_cost),
            bench(f"{kind}/K2-butterfly",
                  (lambda x: bf_ntt.butterfly(x, bf_t, None, inverse)) if on_card else None,
                  a, bf_cost),
            bench(f"{kind}/plain-four-step",
                  lambda x: ntt_mxu.ntt_plain(x, fs_t, None, inverse), a4, fs_cost),
            bench(f"{kind}/K1-four-step",
                  (lambda x: fs_ntt.four_step(x, fs_t, None, inverse)) if on_card else None,
                  a4, fs_cost))

    for inverse in (False, True):
        plain_bf, k2, plain_fs, k1 = transforms(inverse)
        for name, o in (("K2", k2), ("four-step", plain_fs), ("K1", k1)):
            same = NOT_RUN if o is None else bool(torch.equal(plain_bf, o))
            print(f"bit-exact match ({name}{' inverse' if inverse else ''}): {same}")
        del plain_bf, k2, plain_fs, k1
    del a, a4, bf_t, fs_t

    # one rotation and one ct-ct multiplication at the top level
    ctx = Context(CkksParams(ring_n=n, mult_depth=args.depth), device=device)
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys([1])
    ev = Evaluator(ctx, keys)
    ct = keys.encrypt(rng.uniform(0, 1, n // 2))
    Lq, K, D, alpha = roofline.ks_geometry(ctx, ct.level)
    ntt = "butterfly" if ctx.ntt_impl == "butterfly" else "fourstep"
    print(f"# context: ring {n}, depth {args.depth}, Lq={ctx.num_q}, K={ctx.num_sp}, "
          f"NTT {ctx.ntt_impl}")

    def timed(fn):
        fn()
        nttm.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        nttm.synchronize(device)
        return (time.perf_counter() - t0) / args.iters

    for name, cost, fn in (
            ("rotate(keyswitch)", roofline.keyswitch(n, Lq, K, D, alpha, ntt=ntt),
             lambda: ev.rotate(ct, 1)),
            ("mult(ct,ct)+relin", roofline.ct_mult(n, Lq, K, D, alpha, ntt=ntt),
             lambda: ev.mult(ct, ct))):
        dt = timed(fn)
        if on_card:
            print(f"{roofline.report(name, cost, dt)} ({where})")
        else:
            print(f"{name}: measured {dt * 1e3:.2f} ms ({where}), SoL {cost.sol_seconds() * 1e3:.2f}"
                  f" ms on {roofline.H100.name} ({cost.bound()}-bound); {share(cost, dt)}")


if __name__ == "__main__":
    main()
