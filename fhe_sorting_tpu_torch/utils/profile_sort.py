"""Where a DirectSort's device time goes: one sort under `torch.profiler`.

    python -m fhe_sorting_tpu_torch.utils.profile_sort --path per_op
    python -m fhe_sorting_tpu_torch.utils.profile_sort --path staged
    python -m fhe_sorting_tpu_torch.utils.profile_sort --path staged --ntt butterfly

Builds the context (butterfly NTT for `per_op`, the default NTT for
`staged`, or the one `--ntt` names), keys and sorter at N=128, ring 2^17, runs a warm-up sort, then one sort
under the profiler, and prints: the sort's wall-clock with and without the
profiler, the device time of all kernels, the share of the wall-clock the
device was busy (the union of kernel intervals), device time by kernel
class, and the kernels that took most.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import Counter

import numpy as np
import torch

CLASSES = (
    ("K2 bf_cluster_kernel", ("bf_cluster_kernel",)),
    ("K1 modmm_kernel", ("modmm_kernel",)),
    ("fp64 GEMM (mod_matmul)", ("gemm", "cutlass", "cublas", "dgemm")),
    ("gather / index (Galois permutation, limb subsets)", ("index", "gather", "scatter")),
    ("copy / cat / memcpy / memset", ("catarray", "copy", "memcpy", "memset")),
    ("reduce", ("reduce",)),
    ("int64 / fp64 elementwise", ("elementwise",)),
)


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


def sort_context(N: int, path: str, ntt: str):
    """(context, sign config, depth) of a DirectSort of N values at ring
    2^17: the composite-scaling chain (scale 2^56, comp 2), the registry's
    sign config, the depth from the depth meter."""
    from ..core.context import CkksParams, Context
    from ..ops.sign import CompositeSignConfig, SignConfig
    from .depth_meter import measure_direct_sort_depth
    from .params_registry import direct_sort_sign_cfg

    cfg = SignConfig(CompositeSignConfig(*direct_sort_sign_cfg(N)))
    depth = measure_direct_sort_depth(N, RING, cfg, staged=path == "staged")["mult_depth"]
    ctx = Context(CkksParams(ring_n=RING, mult_depth=depth, scale_bits=56, comp=2,
                             base_limbs=4, dnum=3, ntt_impl=ntt))
    return ctx, cfg, depth


def rotation_steps(N: int, path: str, lazy_key_budget: int | None = None) -> list[int]:
    """The rotation keys a path keeps resident: the minimal scan set
    (`staged`), the full per-op set, or none where the per-op sort's composer
    generates keys just in time (`lazy_key_budget`)."""
    from ..models.direct_sort import rotation_indices_direct_sort
    from ..parallel.direct_staged import scan_rotation_indices

    if path == "staged":
        return sorted(scan_rotation_indices(N, RING))
    return [] if lazy_key_budget else sorted(rotation_indices_direct_sort(N, RING))


def sorter(ctx, cfg, N: int, path: str, lazy_key_budget: int | None = None):
    """(keys, sort, composer) on `ctx`: keys from seed 0 with the path's
    rotation keys, `sort(ct)` the whole sort, the per-op sort's
    RotationComposer (None on the staged path)."""
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..models.direct_sort import DirectSort
    from ..ops.sign import SignFunc
    from ..parallel.direct_staged import StagedDirectSort

    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys(rotation_steps(N, path, lazy_key_budget))
    ev = Evaluator(ctx, keys)
    if path == "staged":
        return keys, StagedDirectSort(ev, N, cfg), None
    srt = DirectSort(ev, N, lazy_key_budget=lazy_key_budget)
    return keys, (lambda ct: srt.sort(ct, SignFunc.CompositeSign, cfg)), srt.rot


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("per_op", "staged"), default="per_op")
    ap.add_argument("--ntt", choices=("auto", "butterfly", "mxu"), default=None,
                    help="ntt_impl of the context (default: butterfly for per_op, auto for staged)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_sort: no CUDA device")

    smi = card()
    N, ring, top = 128, RING, 12
    ctx, cfg, depth = sort_context(
        N, args.path, args.ntt or ("butterfly" if args.path == "per_op" else "auto"))
    keys, sort, _ = sorter(ctx, cfg, N, args.path)
    vals = np.random.default_rng(0).permutation(N) / N + 0.5 / N
    ct = keys.encrypt(vals)

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
    err = float(np.abs(keys.decrypt(out, N) - np.sort(vals)).max())

    by_name, by_class, launches, spans = Counter(), Counter(), Counter(), []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_name[e.name] += us
        launches[e.name] += 1
        by_class[_classify(e.name)] += us
        spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        raise SystemExit("profile_sort: the profiler recorded no device activity")
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e_ in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    total = sum(by_name.values())

    print(f"{smi}")
    print(f"# {args.path} DirectSort N={N}, ring {ring}, depth {depth}, ntt {ctx.ntt_impl}; "
          f"max error {err:.3e}")
    print(f"# wall: warm-up {warm_s:.3f}s, plain {plain_s:.3f}s, profiled {prof_s:.3f}s")
    print(f"# device time of all kernels {total / 1e6:.3f}s in {sum(launches.values())} "
          f"launches; device busy {busy / 1e6:.3f}s = {100 * busy / 1e6 / prof_s:.1f}% of the "
          f"profiled wall ({smi})")
    for label, us in by_class.most_common():
        print(f"#   {100 * us / total:5.1f}%  {us / 1e6:7.3f}s  {label}")
    print(f"# top {top} kernels by device time:")
    for name, us in by_name.most_common(top):
        print(f"#   {100 * us / total:5.1f}%  {us / 1e6:7.3f}s  {launches[name]:6d}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
