"""Microbenchmark of the Galois automorphism's three forms on ciphertext-shaped
planes [B, L, n]: the port of `benchmarks/auto_microbench.py`.

  1. gather  - `data[..., perm]`, the evaluator's default automorphism;
  2. roll    - `torch.roll`, the lower bound of any layout in which the
               automorphism were a cyclic shift;
  3. affine  - `core/auto_affine.apply_affine`, the gather-free path
               (`FHE_AFFINE_AUTO`), on the chain's real tables.

Each form is timed on the device (CUDA events on the card; the host clock
where the CPU is asked for), and the affine result is held equal to the
gather for every galois element checked (rotations and conjugation) before
anything is timed.  Beside the times: the gather's bound, its bytes (each
input read once, each output written once) over the card's memory rate, and
the affine path's, its float64 products over the card's float64 rate, both
on `roofline.H100`.

    python -m fhe_sorting_tpu_torch.utils.auto_microbench [--limbs 91]
        [--ring 131072] [--depth 32] [--batch 2] [--reps 20] [--device cpu]

The default chain is the staged N=128 sort's (depth 32: 68 Q primes and 23
special primes, 91 in all).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..core.auto_affine import apply_affine
from ..core.ntt import device_name, synchronize
from ..core.ntt_mxu import split_n
from .hbm_budget import RESIDUE_BYTES
from .roofline import H100


def affine_flops(batch: int, limbs: int, n: int) -> float:
    """Float64 operations of one `apply_affine` on [batch, limbs, n] (a
    multiply-add counted as two): per plane the one-hot row and lane
    products and two DFTs of four half products each; per limb the twiddle's
    one-hot product."""
    n1, n2 = split_n(n)
    per_plane = 2 * n1 * n1 * n2 + 2 * n1 * n2 * n2 + 2 * 4 * 2 * n1 * n2 * n2
    return batch * limbs * per_plane + limbs * 2 * n2 * n2 * n1


def bounds_ms(batch: int, limbs: int, n: int) -> dict:
    """The gather's bound (bytes) and the affine path's (float64 products,
    over the tensor cores' float64 rate), in ms on `roofline.H100`."""
    moved = 2 * batch * limbs * n * RESIDUE_BYTES
    return {"gather_bound_ms": moved / H100.hbm_bytes_s * 1e3,
            "affine_bound_ms": max(moved / H100.hbm_bytes_s,
                                   affine_flops(batch, limbs, n) / H100.fp64_flops_s) * 1e3}


def time_ms(fn, reps: int, device: torch.device) -> float:
    """Mean milliseconds of fn() over `reps` runs after a warm-up: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    synchronize(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    synchronize(device)
    return start.elapsed_time(end) / reps


def galois_elements(ctx, rotations=(1, -1, 64)) -> dict:
    """Named galois elements: the rotations, and conjugation."""
    out = {f"rotate {r}": ctx.galois_element_rot(r) for r in rotations}
    out["conjugate"] = 2 * ctx.params.ring_n - 1
    return out


def bench(ctx, limbs: torch.Tensor, batch: int, reps: int, rotations=(1, -1, 64),
          seed: int = 0) -> dict:
    """Random residues [batch, len(limbs), n] over the chain's `limbs`: the
    affine path held equal to the gather for every element of
    `galois_elements(ctx, rotations)` (AssertionError otherwise), then the
    three forms timed at the first rotation."""
    dev = ctx.device
    n = ctx.params.ring_n
    tables = ctx.auto_tables().select(limbs)
    p = tables.p.view(-1, 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.remainder(torch.randint(0, 1 << 62, (batch, len(limbs), n), generator=gen,
                                      device=dev, dtype=torch.int64), p)
    elements = galois_elements(ctx, rotations)
    for name, g in elements.items():
        if not torch.equal(apply_affine(x, ctx.galois_affine(g), tables), x[..., ctx.galois_perm(g)]):
            raise AssertionError(f"affine automorphism differs from the gather ({name}, "
                                 f"[{batch}, {len(limbs)}, {n}])")
    g = elements[f"rotate {rotations[0]}"]
    perm, consts = ctx.galois_perm(g), ctx.galois_affine(g)
    out = {"shape": [batch, len(limbs), n],
           "gather_ms": time_ms(lambda: x[..., perm], reps, dev),
           "roll_ms": time_ms(lambda: torch.roll(x, 12345, dims=-1), reps, dev),
           "affine_ms": time_ms(lambda: apply_affine(x, consts, tables), reps, dev),
           **bounds_ms(batch, len(limbs), n),
           "checked": list(elements)}
    # a share of the card's bound means something only for a time on the card
    out["affine_share_of_bound"] = (out["affine_bound_ms"] / out["affine_ms"]
                                    if dev.type == "cuda" else None)
    return out


def profile(ctx, limbs: torch.Tensor, batch: int, top: int = 10, seed: int = 0) -> str:
    """Where one `apply_affine` of [batch, len(limbs), n] spends its time:
    `torch.profiler`'s table of its kernels by device time (host time on the
    CPU), after a warm-up call."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    dev = ctx.device
    tables = ctx.auto_tables().select(limbs)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.remainder(torch.randint(0, 1 << 62, (batch, len(limbs), ctx.params.ring_n),
                                      generator=gen, device=dev, dtype=torch.int64),
                        tables.p.view(-1, 1))
    consts = ctx.galois_affine(ctx.galois_element_rot(1))
    apply_affine(x, consts, tables)
    synchronize(dev)
    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=acts) as prof:
        apply_affine(x, consts, tables)
        synchronize(dev)
    return prof.key_averages().table(
        sort_by="self_cuda_time_total" if cuda else "self_cpu_time_total", row_limit=top)


def describe(r: dict) -> str:
    shape = "[" + ", ".join(map(str, r["shape"])) + "]"
    share = r["affine_share_of_bound"]
    share = "" if share is None else f", {100 * share:.1f}% of it"
    return (f"automorphism of {shape}: gather {r['gather_ms']:.3f} ms (H100 bound "
            f"{r['gather_bound_ms']:.3f} ms by bytes), roll {r['roll_ms']:.3f} ms, affine "
            f"{r['affine_ms']:.3f} ms (H100 bound {r['affine_bound_ms']:.3f} ms by float64 "
            f"products{share}); affine == gather for {', '.join(r['checked'])}")


def main(argv=None) -> dict:
    from ..core.context import CkksParams, Context

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--limbs", type=int, default=91)
    ap.add_argument("--ring", type=int, default=131072)
    ap.add_argument("--depth", type=int, default=32)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default=None, help="default: the first CUDA card")
    args = ap.parse_args(argv)

    ctx = Context(CkksParams(ring_n=args.ring, mult_depth=args.depth, scale_bits=56, comp=2,
                             base_limbs=4, ntt_impl="butterfly"), device=args.device)
    total = ctx.num_q + ctx.num_sp
    if not 0 < args.limbs <= total:
        raise SystemExit(f"--limbs {args.limbs}: the chain has {total} primes")
    r = bench(ctx, ctx.limbs_range(0, args.limbs), args.batch, args.reps)
    r["device"] = device_name(ctx.device)
    print(f"# {describe(r)} ({r['device']})")
    print(json.dumps({"metric": "automorphism_ms", **r}))
    return r


if __name__ == "__main__":
    main()
