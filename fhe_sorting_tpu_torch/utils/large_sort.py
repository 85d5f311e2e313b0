"""One sort at a large N on the card, with its memory reckoned first.

    python -m fhe_sorting_tpu_torch.utils.large_sort --n 1024 --path per_op
    python -m fhe_sorting_tpu_torch.utils.large_sort --n 1024 --path staged [--eager]
    python -m fhe_sorting_tpu_torch.utils.large_sort --n 512 --path hybrid
    python -m fhe_sorting_tpu_torch.utils.large_sort --n 512 --algo mehp24_staged

DirectSort (`--algo direct`, the default) by one of three paths: `per_op`
keys nothing up front and lets the sort's RotationComposer generate each
rotation key just in time on the device, at most 8 of them resident;
`staged` keys the minimal scan set; both are `profile_sort`'s configuration
(ring 2^17, scale 2^56 with comp 2, the depth from the depth meter).
`hybrid` is the staged hybrid sort over 256-wide tiles (`staged_hybrid`),
and `--algo mehp24_staged` the MEHP24 triangle over sub-length 256
(`staged_mehp24`).  All run on the butterfly NTT; the staged ones run on
CUDA graphs (`parallel/whole_graph.py`), or eagerly with `--eager`, and
print the graphs' capture seconds.  Prints the card, the
reckoned and the measured peak memory, seconds of a warm-up sort and of a
timed one, and the max error against np.sort; exits non-zero on an error
>= 0.01, and raises where the peak exceeds the reckoning's budget.
`sharded_direct` and `sharded_mehp24` build the sharded sorts of
`chip_smoke.py` phase 13.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

LAZY_KEY_BUDGET = 8
TILE = 256                       # the reference's tile: 256 values, 256x256 slots
LOGQP_128 = 3524                 # ring 2^17, HEStd_128_classic


def _context(depth: int, dnum: int):
    from ..core.context import CkksParams, Context
    from .profile_sort import RING

    ctx = Context(CkksParams(ring_n=RING, mult_depth=depth, scale_bits=56, comp=2,
                             base_limbs=4, dnum=dnum, ntt_impl="butterfly"))
    logqp = sum(math.log2(p) for p in ctx.all_primes)
    if logqp > LOGQP_128:
        raise ValueError(f"logQP {logqp:.1f} exceeds the 128-bit budget {LOGQP_128}")
    return ctx, logqp


def _hold_rotation_keys(keys, steps):
    """Keep exactly the rotation keys of `steps`: drop the others, generate
    the missing ones."""
    ctx = keys.ctx
    want = {ctx.galois_element_rot(s % (ctx.params.ring_n // 2)): s for s in steps}
    for g in [g for g in keys.rot if g not in want]:
        del keys.rot[g]
    keys.gen_rotation_keys(sorted(s for g, s in want.items() if g not in keys.rot))


def _metered_depth(make_sort, slots: int) -> int:
    """The least chain depth of `make_sort(ev)`'s sort of a `slots`-slot
    ciphertext at ring 2^17, metered on a data-free evaluator: the deepest
    level it reaches, plus one where the result has scale degree 2."""
    from ..core.cipher import Ciphertext
    from .depth_meter import MeterEvaluator
    from .profile_sort import RING

    meter = MeterEvaluator(RING)
    out = make_sort(meter)(Ciphertext(None, 0, 1, slots))
    return meter.max_level + (out.sdeg == 2)


def hybrid_plan(N: int):
    """(sign config, depth) of the staged hybrid DirectSort of N values: the
    registry's sign config and the depth metered on `StagedHybridSort`."""
    from ..ops.sign import CompositeSignConfig, SignConfig
    from ..parallel.hybrid_staged import StagedHybridSort
    from .params_registry import direct_sort_sign_cfg

    cfg = SignConfig(CompositeSignConfig(*direct_sort_sign_cfg(N)))
    return cfg, _metered_depth(lambda ev: StagedHybridSort(ev, N, cfg, max_array=TILE), N)


def mehp24_plan(total: int):
    """((dg_c, df_c, dg_i, df_i), depth) of the staged MEHP24 sort of `total`
    values: the reference's N=512 run's configuration (dg_i 4 below 512), and
    the depth metered on `StagedMehp24Multi` plus one spare level, the
    reference run's chain (46 at N=512)."""
    from ..parallel.mehp24_staged import StagedMehp24Multi

    sign = (3, 2, (5 if total >= 512 else 4), 2)
    return sign, _metered_depth(lambda ev: StagedMehp24Multi(ev, total, TILE, *sign),
                                TILE * TILE) + 1


def staged_hybrid(N: int, graphs: bool | None = None):
    """(ctx, keys, sort, info) of the staged hybrid DirectSort of N values
    over 256-wide tiles at ring 2^17 (`hybrid_plan`), dnum 5 (logQP 3396.8
    at depth 48 and N=512).  `sort(ct)` holds constructRank's scan keys, ranks,
    swaps them for the placement basis, and places, so the device holds one
    key set at a time; `info["phase_s"]` has the last sort's seconds by
    phase."""
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..parallel.direct_staged import scan_rotation_indices
    from ..parallel.hybrid_staged import StagedHybridSort, hybrid_staged_keys
    from . import hbm_budget
    from .profile_sort import RING

    cfg, depth = hybrid_plan(N)
    ctx, logqp = _context(depth, 5)
    scan, place = scan_rotation_indices(N, RING), hybrid_staged_keys(N, RING, TILE)
    nb = max(1, N // TILE)
    work = hbm_budget.work_cts("hybrid_staged", graphs is not False)
    reports = [hbm_budget.check_phase(ctx, len(scan), 4, work_cts=work, label="constructRank"),
               # 2*nb rotated inputs + nb accumulators + rank + input
               hbm_budget.check_phase(ctx, len(place), 3 * nb + 2, work_cts=work, label="place")]
    keys = Keys.generate(ctx, seed=0)
    srt = StagedHybridSort(Evaluator(ctx, keys), N, cfg, max_array=TILE, graphs=graphs)
    info = dict(depth=depth, logqp=logqp, reports=reports, slots=N, phase_s={}, stages=srt.stages,
                what=f"staged hybrid DirectSort N={N} over {TILE}-wide tiles "
                     f"(indicator dg {srt.dgi}, {len(scan)} scan keys, then {len(place)} "
                     f"placement keys)")

    def stamp(t):
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        t.append(time.time())

    def sort(ct):
        t = [time.time()]
        # a graph holds the keys it read: drop the graphs before their keys go
        srt.stages.release()
        _hold_rotation_keys(keys, scan)
        stamp(t)
        rank = srt.base.construct_rank(ct)
        stamp(t)
        srt.stages.release()
        _hold_rotation_keys(keys, place)
        stamp(t)
        out = srt.place(rank, ct)
        stamp(t)
        info["phase_s"] = dict(zip(("scan keys", "constructRank", "placement keys", "place"),
                                   np.diff(t)))
        return out

    return ctx, keys, sort, info


def staged_mehp24(total: int, graphs: bool | None = None):
    """(ctx, keys, sort, info) of the MEHP24 triangle sort of `total` values
    over 256x256 tiles at ring 2^17 (`mehp24_plan`), dnum 4.  `sort(ct)`
    takes the values in the first `total` of 256 * 256 slots."""
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..parallel.mehp24_staged import StagedMehp24Multi, mehp24_staged_keys
    from . import hbm_budget
    from .profile_sort import RING

    sign, depth = mehp24_plan(total)
    ctx, logqp = _context(depth, 4)
    steps = sorted(mehp24_staged_keys(TILE, RING))
    k = total // TILE
    # the parts, their two replications, the Cv/Ch accumulators and the ranks
    report = hbm_budget.check_phase(ctx, len(steps), 6 * k,
                                    work_cts=hbm_budget.work_cts("mehp24_staged",
                                                                 graphs is not False),
                                    label="MEHP24 staged")
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys(steps)
    srt = StagedMehp24Multi(Evaluator(ctx, keys), total, TILE, *sign, graphs=graphs)
    info = dict(depth=depth, logqp=logqp, reports=[report], slots=TILE * TILE, phase_s={},
                stages=srt.stages, what=f"staged MEHP24 N={total} over {k} tiles of {TILE}x{TILE} "
                     f"(dg_c {sign[0]}, df_c {sign[1]}, dg_i {sign[2]}, df_i {sign[3]}; "
                     f"{len(steps)} keys)")
    return ctx, keys, srt, info


def sharded_plan(N: int, mesh):
    """(sign config, depth) of the sharded DirectSort of N values: the
    registry's sign config and the depth metered on `ShardedDirectSort`."""
    from ..ops.sign import CompositeSignConfig, SignConfig
    from ..parallel.direct_sharded import ShardedDirectSort
    from .params_registry import direct_sort_sign_cfg

    cfg = SignConfig(CompositeSignConfig(*direct_sort_sign_cfg(N)))
    return cfg, _metered_depth(lambda ev: ShardedDirectSort(ev, N, cfg, mesh=mesh), N)


def sharded_direct(N: int, mesh):
    """(ctx, keys, sort, info) of the DirectSort of N values with its
    batches sharded over `mesh` (`ShardedDirectSort`) at ring 2^17, dnum 3
    (`profile_sort`'s chain): the sharded rotation keys and the num_batch
    offset keys, all resident."""
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..parallel.direct_sharded import ShardedDirectSort, rotation_indices_sharded
    from . import hbm_budget
    from .profile_sort import RING

    cfg, depth = sharded_plan(N, mesh)
    ctx, logqp = _context(depth, 3)
    steps = sorted(rotation_indices_sharded(N, RING))
    nb = N // min(N, (RING // 2) // N)
    # the input, the rank, its index difference and a batch sum
    report = hbm_budget.check_phase(ctx, len(steps) + nb, 4,
                                    work_cts=hbm_budget.WORK_CTS["direct_sharded"],
                                    label=f"sharded DirectSort N={N}")
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys(steps)
    srt = ShardedDirectSort(Evaluator(ctx, keys), N, cfg, mesh=mesh)
    info = dict(depth=depth, logqp=logqp, reports=[report], slots=N, phase_s={},
                what=f"sharded DirectSort N={N} ({nb} batches over {mesh.size()} rank(s); "
                     f"{len(steps)} rotation + {nb} offset keys)")
    return ctx, keys, srt, info


def sharded_mehp24(total: int, mesh):
    """(ctx, keys, sort, info) of the MEHP24 triangle of `total` values in
    256 x 256 parts split over `mesh` (`ShardedMehp24`), on the staged
    MEHP24 chain (`mehp24_plan`, dnum 4) with the keys
    `rotation_indices_mehp24(256)` asks for.  `sort(parts)` takes the parts,
    each holding its values in the first 256 of 256 * 256 slots."""
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..models.mehp24.utils import rotation_indices_mehp24
    from ..parallel.mehp24_sharded import ShardedMehp24
    from . import hbm_budget

    sign, depth = mehp24_plan(total)
    ctx, logqp = _context(depth, 4)
    steps = sorted(rotation_indices_mehp24(TILE))
    k = total // TILE
    # +-2^15 are one galois element at ring 2^17
    n_keys = len({ctx.galois_element_rot(s) for s in steps})
    report = hbm_budget.check_phase(ctx, n_keys, 6 * k,
                                    work_cts=hbm_budget.WORK_CTS["mehp24_sharded"],
                                    label=f"sharded MEHP24 N={total}")
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys(steps)
    srt = ShardedMehp24(Evaluator(ctx, keys), TILE, k, *sign, mesh=mesh)
    info = dict(depth=depth, logqp=logqp, reports=[report], slots=TILE * TILE, phase_s={},
                what=f"sharded MEHP24 N={total} over {k} parts of {TILE}x{TILE} "
                     f"({len(srt.pairs)} of {k * (k + 1) // 2} pairs on this rank; "
                     f"{len(keys.rot)} keys)")
    return ctx, keys, srt, info


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--path", choices=("per_op", "staged", "hybrid"), default="per_op")
    ap.add_argument("--algo", choices=("direct", "mehp24_staged"), default="direct")
    ap.add_argument("--eager", action="store_true",
                    help="run the staged sorts eagerly instead of on CUDA graphs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("large_sort: no CUDA device")

    from . import hbm_budget
    from .profile_sort import RING, card, rotation_steps, sort_context, sorter

    smi = card()
    print(smi)
    N, ring = args.n, RING
    t0 = time.time()
    rot, info = None, None
    graphs = False if args.eager else None
    if args.algo == "mehp24_staged":
        ctx, keys, sort, info = staged_mehp24(N, graphs)
    elif args.path == "hybrid":
        ctx, keys, sort, info = staged_hybrid(N, graphs)
    else:
        ctx, cfg, depth = sort_context(N, args.path, "butterfly")
        resident = len(rotation_steps(N, args.path, LAZY_KEY_BUDGET)) or LAZY_KEY_BUDGET
        work = hbm_budget.work_cts(f"direct_{args.path}",
                                   args.path == "staged" and not args.eager)
        report = hbm_budget.check_phase(ctx, resident, 8, work_cts=work,
                                        label=f"{args.path} DirectSort N={N}")
        print(f"# {args.path} DirectSort N={N}, ring {ring}, depth {depth}, Lq={ctx.num_q}, "
              f"K={ctx.num_sp}; reckoned before allocating: {report}")
        keys, sort, rot = sorter(ctx, cfg, N, args.path, LAZY_KEY_BUDGET, graphs)
    if info is not None:
        report = max(info["reports"], key=lambda r: r["used_gib"])
        print(f"# {info['what']}, ring {ring}, depth {info['depth']}, Lq={ctx.num_q}, "
              f"K={ctx.num_sp}, logQP {info['logqp']:.1f}; reckoned before allocating: "
              f"{info['reports']}")
    torch.cuda.synchronize()
    print(f"# context and keys ({len(keys.rot)} rotation + relin) {time.time() - t0:.1f}s")

    vals = np.random.default_rng(0).permutation(N) / N + 0.5 / N
    slots = info["slots"] if info is not None else N
    pad = np.zeros(slots)
    pad[:N] = vals
    ct = keys.encrypt(pad, slots=slots)
    secs, peaks = [], []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        lazy0 = rot.stats.lazy_keygens if rot else 0
        t0 = time.time()
        out = sort(ct)
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
    lazy = (rot.stats.lazy_keygens - lazy0) if rot else 0
    peak = max(peaks)
    stages = getattr(sort, "stages", None) or (info or {}).get("stages")
    if stages is not None:
        print(f"# stages {'on CUDA graphs' if stages.graphs else 'eager'}: {len(stages)} stages, "
              f"{stages.graph_count()} graphs held, capture {stages.capture_seconds():.2f}s "
              f"(host seconds, in the warm-up); peak in the warm-up {peaks[0]:.2f} GiB, in the "
              f"timed sort {peaks[1]:.2f} GiB ({smi})")
    err = float(np.abs(keys.decrypt(out, N) - np.sort(vals)).max())
    label = f"{args.algo} {args.path}" if args.algo == "direct" else args.algo
    label += " eager" if args.eager else ""
    phases = ", ".join(f"{k} {v:.2f}s" for k, v in (info or {}).get("phase_s", {}).items())
    print(f"# {label} N={N}: warm-up {secs[0]:.2f}s, timed {secs[1]:.2f}s"
          f"{f' ({phases})' if phases else ''}; max error {err:.3e}; lazy keygens in the timed "
          f"sort {lazy}; output level {out.level}; peak device memory {peak:.2f} GiB measured, "
          f"{report['used_gib']} GiB reckoned, {report['budget_gib']} GiB budget ({smi})")
    hbm_budget.check_peak(report, peak)
    return 0 if err < 0.01 else 1


if __name__ == "__main__":
    raise SystemExit(main())
