"""Where a staged sort's device time goes: one sort under `torch.profiler`.

    python -m fhe_sorting_tpu_torch.utils.profile_sort --path per_op
    python -m fhe_sorting_tpu_torch.utils.profile_sort --path staged
    python -m fhe_sorting_tpu_torch.utils.profile_sort --path staged --ntt butterfly
    python -m fhe_sorting_tpu_torch.utils.profile_sort --sort mehp24
    python -m fhe_sorting_tpu_torch.utils.profile_sort --sort hybrid

Builds the context (butterfly NTT for `per_op`, the default NTT for
`staged`, or the one `--ntt` names), keys and sorter: the DirectSort at
N=128, ring 2^17 (`--sort direct`, the default), the staged MEHP24 sort
at N=512 over two 256x256 tiles (`--sort mehp24`, staged only:
`large_sort.staged_mehp24` on the default NTT), or the staged hybrid
DirectSort at N=512 over two 256-wide tiles (`--sort hybrid`, staged only:
`large_sort.staged_hybrid` on the default NTT).  Runs a warm-up sort, then
one sort under the profiler, and prints: the sort's wall-clock with and
without the profiler, the device time of all kernels and how many ran, the
host's launch calls (kernel launches and graph launches), the share of the
wall-clock the device was busy (the union of kernel intervals), device time
by kernel class, and the kernels that took most.  The staged path runs
twice on the same keys and input: eagerly (`graphs=False`) and on CUDA
graphs (the default on the card).  From the program's spans
(`core/trace.py`, recorded while the profiler runs) it prints, for every
run, each stage's dispatches and device seconds against the device's busy
time, and for an eager run the op census: each kernel's device time charged
to the innermost evaluator op span (`ev.*`) around the host call that
launched it (matched by the profiler's correlation id), by op and kernel
class, ranked.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import Counter

import numpy as np
import torch

from ..core.cuda_build import KERNELS

# the hand-written kernels first, one class each ("K1 fs_ntt", ...)
CLASSES = tuple((f"{key.upper()} {k.source}", k.functions) for key, k in KERNELS.items()) + (
    ("fp64 GEMM (mod_matmul)", ("gemm", "cutlass", "cublas", "dgemm")),
    ("gather / index (Galois permutation, limb subsets)", ("index", "gather", "scatter")),
    ("copy / cat / memcpy / memset", ("catarray", "copy", "memcpy", "memset")),
    ("reduce", ("reduce",)),
    ("int64 / fp64 elementwise", ("elementwise",)),
)


OUTSIDE = "(outside an op)"


def _classify(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k.lower() in low for k in keys):
            return label
    return "other"


RING = 1 << 17


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sort_context(N: int, path: str, ntt: str = "auto", ring: int = RING,
                 depth: int | None = None, sign: tuple = (None, None, None), comp: int = 2,
                 dnum: int = 3, device=None):
    """(context, sign config, depth) of a DirectSort of N values: the
    composite-scaling chain (comp 2: scale 2^56 from prime pairs over 4
    base limbs; comp 1: 2^28 over 2), the registry's sign config with each
    of `sign`'s (cn, dg, df) that is not None in its place, and the depth
    from the depth meter unless `depth` is given."""
    from ..core.context import CkksParams, Context
    from ..ops.sign import CompositeSignConfig, SignConfig
    from .depth_meter import measure_direct_sort_depth
    from .params_registry import direct_sort_sign_cfg

    cfg = SignConfig(CompositeSignConfig(*(r if o is None else o for o, r in
                                           zip(sign, direct_sort_sign_cfg(N)))))
    if depth is None:
        depth = measure_direct_sort_depth(N, ring, cfg, staged=path == "staged")["mult_depth"]
    ctx = Context(CkksParams(ring_n=ring, mult_depth=depth, scale_bits=56 if comp == 2 else 28,
                             comp=comp, base_limbs=4 if comp == 2 else 2, dnum=dnum,
                             ntt_impl=ntt), device=device)
    return ctx, cfg, depth


def rotation_steps(N: int, path: str, lazy_key_budget: int | None = None,
                   ring: int = RING) -> list[int]:
    """The rotation keys a path keeps resident: the minimal scan set
    (`staged`), the full per-op set, or none where the per-op sort's composer
    generates keys just in time (`lazy_key_budget`)."""
    from ..models.direct_sort import rotation_indices_direct_sort
    from ..parallel.direct_staged import scan_rotation_indices

    if path == "staged":
        return sorted(scan_rotation_indices(N, ring))
    return [] if lazy_key_budget else sorted(rotation_indices_direct_sort(N, ring))


def sorter(ctx, cfg, N: int, path: str, lazy_key_budget: int | None = None,
           graphs: bool | None = None):
    """(keys, sort, composer) on `ctx`: keys from seed 0 with the path's
    rotation keys, `sort(ct)` the whole sort, the per-op sort's
    RotationComposer (None on the staged path).  `graphs` is the staged
    sort's (None: CUDA graphs on a CUDA context)."""
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..models.direct_sort import DirectSort
    from ..ops.sign import SignFunc
    from ..parallel.direct_staged import StagedDirectSort

    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys(rotation_steps(N, path, lazy_key_budget, ctx.params.ring_n))
    ev = Evaluator(ctx, keys)
    if path == "staged":
        return keys, StagedDirectSort(ev, N, cfg, graphs), None
    srt = DirectSort(ev, N, lazy_key_budget=lazy_key_budget)
    return keys, (lambda ct: srt.sort(ct, SignFunc.CompositeSign, cfg)), srt.rot


def op_census(prof, spans) -> Counter:
    """Device seconds by (evaluator op, kernel class): each kernel's time
    charged to the innermost `ev.*` span around the host runtime call that
    launched it (the call's correlation id is the kernel's), or to
    `OUTSIDE`."""
    cuda = torch.autograd.DeviceType.CUDA
    names = {s.name for s in spans}
    launched, kernels = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            # an annotation's extent on the device timeline is no kernel
            if not (e.is_user_annotation() or e.name() in names):
                kernels.append((e.correlation_id(), e.name(), (e.end_ns() - e.start_ns()) / 1e9))
        elif e.name().startswith("cu") and e.correlation_id():
            launched[e.correlation_id()] = e.start_ns()
    # a sweep over the op spans' starts (0), the launches (1) and the ends
    # (2): the spans nest, so the innermost open one owns a launch
    marks = [(s.start, 0, s.name) for s in spans if s.name.startswith("ev.")]
    marks += [(s.end, 2, None) for s in spans if s.name.startswith("ev.")]
    marks += [(launched[c], 1, i) for i, (c, _, _) in enumerate(kernels) if c in launched]
    owner, open_ = {}, []
    for _, kind, x in sorted(marks, key=lambda m: m[:2]):
        if kind == 0:
            open_.append(x)
        elif kind == 2:
            open_.pop()
        else:
            owner[x] = open_[-1] if open_ else OUTSIDE
    out = Counter()
    for i, (_, name, secs) in enumerate(kernels):
        out[(owner.get(i, "(launch not found)"), _classify(name))] += secs
    return out


def stage_table(spans) -> dict:
    """Per stage dispatch span name: [dispatches, host s, device s, NTT
    planes, the launches of each kernel of `cuda_build.KERNELS` in its
    order, evaluator ops], summed over its dispatches."""
    out = {}
    for s in spans:
        if "kind" in s.counts:
            c = s.counts
            row = out.setdefault(s.name, [0, 0.0, 0.0, 0] + [0] * len(KERNELS) + [0])
            row[0] += 1
            row[1] += (s.end - s.start) / 1e9
            row[2] += (s.device[1] - s.device[0]) / 1e9 if s.device else 0.0
            row[3] += c["planes"]
            for i, key in enumerate(KERNELS, 4):
                row[i] += c[key]
            row[-1] += c["ops"]
    return out


def profile(sort, ct, label: str, smi: str, top: int = 12) -> dict:
    """A warm-up sort, a plain one and one under the profiler; prints what
    the module docstring lists and returns the output and the numbers."""

    def timed():
        torch.cuda.synchronize()
        t0 = time.time()
        out = sort(ct)
        torch.cuda.synchronize()
        return out, time.time() - t0

    _, warm_s = timed()
    _, plain_s = timed()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        out, prof_s = timed()

    from ..core import trace

    spans = trace.spans()
    names = {s.name for s in spans}
    by_name, by_class, launches, busy_at, host = Counter(), Counter(), Counter(), [], Counter()
    for e in prof.events():
        # an annotation's extent on the device timeline (the program's spans
        # are annotations) is no kernel
        if getattr(e, "is_user_annotation", False) or e.name in names:
            continue
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                                  "cuGraphLaunch")):
                host["graph" if "Graph" in e.name else "kernel"] += 1
            continue
        us = e.time_range.elapsed_us()
        by_name[e.name] += us
        launches[e.name] += 1
        by_class[_classify(e.name)] += us
        busy_at.append((e.time_range.start, e.time_range.end))
    if not busy_at:
        raise SystemExit("profile_sort: the profiler recorded no device activity")
    busy_at.sort()
    busy, cur_s, cur_e = 0.0, *busy_at[0]
    for s, e_ in busy_at[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    total = sum(by_name.values())
    kernels = sum(launches.values())
    share = 100 * busy / 1e6 / prof_s
    print(f"# {label}: wall: warm-up {warm_s:.3f}s, plain {plain_s:.3f}s, profiled {prof_s:.3f}s")
    print(f"# {label}: device time of all kernels {total / 1e6:.3f}s in {kernels} kernels; "
          f"host launch calls: {host['kernel']} kernel, {host['graph']} graph; device busy "
          f"{busy / 1e6:.3f}s = {share:.1f}% of the profiled wall ({smi})")
    for cls, us in by_class.most_common():
        print(f"#   {100 * us / total:5.1f}%  {us / 1e6:7.3f}s  {cls}")
    print(f"# top {top} kernels by device time:")
    for name, us in by_name.most_common(top):
        print(f"#   {100 * us / total:5.1f}%  {us / 1e6:7.3f}s  {launches[name]:6d}x  {name[:110]}")
    stages = stage_table(spans)
    if stages:
        stage_s = sum(r[2] for r in stages.values())
        print(f"# {label}: {sum(r[0] for r in stages.values())} stage dispatches, device "
              f"{stage_s:.4f}s = {100 * stage_s / (busy / 1e6):.2f}% of the busy time; by stage "
              f"(dispatches, host s, device s, NTT planes, "
              + ", ".join(f"{key.upper()} launches" for key in KERNELS) + ", ops):")
        for name, (n, host_s, dev_s, planes, *launched, ops) in sorted(
                stages.items(), key=lambda kv: -kv[1][2]):
            print(f"#   {name:24s} {n:3d}  {host_s:8.4f}  {dev_s:8.4f}  {planes:7d}  "
                  + "  ".join(f"{k:6d}" for k in launched) + f"  {ops:5d}")
    census = op_census(prof, spans)
    if any(op.startswith("ev.") for op, _ in census):
        print(f"# {label}: op census, device seconds by evaluator op and kernel class ({smi}):")
        for (op, cls), secs in census.most_common():
            print(f"#   {100 * secs / (total / 1e6):5.1f}%  {secs:7.4f}s  {op:18s}  {cls}")
    return dict(out=out, warm_s=warm_s, plain_s=plain_s, prof_s=prof_s, kernels=kernels,
                host=dict(host), busy_share=share)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("per_op", "staged"), default=None,
                    help="default: per_op for DirectSort, staged for MEHP24 and the hybrid")
    ap.add_argument("--ntt", choices=("auto", "butterfly", "mxu"), default=None,
                    help="ntt_impl of the context (default: butterfly for per_op, auto for staged)")
    ap.add_argument("--sort", choices=("direct", "mehp24", "hybrid"), default="direct",
                    help="DirectSort N=128, or the staged MEHP24 or hybrid sort N=512 (staged "
                         "only)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_sort: no CUDA device")
    args.path = args.path or ("per_op" if args.sort == "direct" else "staged")
    if args.sort != "direct" and args.path != "staged":
        raise SystemExit(f"profile_sort: {args.sort} runs staged only (--path staged)")

    smi = card()
    ntt = args.ntt or ("butterfly" if args.path == "per_op" else "auto")
    if args.sort == "mehp24":
        from ..parallel.mehp24_staged import StagedMehp24Multi
        from .large_sort import TILE, staged_mehp24

        N = 512
        ctx, keys, sort, info = staged_mehp24(N, graphs=False, ntt=ntt)
        depth = info["depth"]
        vals = np.random.default_rng(0).permutation(N) / N + 0.5 / N
        pad = np.zeros(TILE * TILE)
        pad[:N] = vals
        ct = keys.encrypt(pad, slots=TILE * TILE)
        runs = {"eager": sort, "graphs": StagedMehp24Multi(sort.ev, N, TILE, *sort.cfg)}
    elif args.sort == "hybrid":
        from ..parallel.hybrid_staged import StagedHybridSort
        from .large_sort import TILE, staged_hybrid

        N = 512
        ctx, keys, sort, info = staged_hybrid(N, graphs=False, ntt=ntt)
        depth = info["depth"]
        vals = np.random.default_rng(0).permutation(N) / N + 0.5 / N
        ct = keys.encrypt(vals, slots=N)
        runs = {"eager": sort, "graphs": StagedHybridSort(sort.ev, N, sort.base.cfg,
                                                          max_array=TILE, indicator_dg=sort.dgi)}
    else:
        N = 128
        ctx, cfg, depth = sort_context(N, args.path, ntt)
        keys, sort, _ = sorter(ctx, cfg, N, args.path, graphs=False)
        vals = np.random.default_rng(0).permutation(N) / N + 0.5 / N
        ct = keys.encrypt(vals)
        runs = {"eager": sort}
        if args.path == "staged":
            from ..parallel.direct_staged import StagedDirectSort

            runs["graphs"] = StagedDirectSort(sort.ev, N, cfg)
    print(f"{smi}")
    print(f"# {args.path} {args.sort} N={N}, ring {RING}, depth {depth}, ntt {ctx.ntt_impl}")
    got = {label: profile(run, ct, f"{args.path} {label}", smi) for label, run in runs.items()}
    for label, r in got.items():
        err = float(np.abs(keys.decrypt(r["out"], N) - np.sort(vals)).max())
        print(f"# {args.path} {label}: max error {err:.3e}")
    if len(got) == 2 and not torch.equal(got["eager"]["out"].data, got["graphs"]["out"].data):
        raise SystemExit("profile_sort: the sort on graphs differs from the eager sort")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
