"""Where a DirectSort's device time goes: one sort under `torch.profiler`.

    python -m fhe_sorting_tpu_torch.utils.profile_sort --path per_op
    python -m fhe_sorting_tpu_torch.utils.profile_sort --path staged

Builds the context (butterfly NTT for `per_op`, the default NTT for
`staged`), keys and sorter at N=128, ring 2^17, runs a warm-up sort, then one sort
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("per_op", "staged"), default="per_op")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_sort: no CUDA device")

    from ..core.context import CkksParams, Context
    from ..core.evaluator import Evaluator
    from ..core.keys import Keys
    from ..models.direct_sort import DirectSort, rotation_indices_direct_sort
    from ..ops.sign import CompositeSignConfig, SignConfig, SignFunc
    from ..parallel.direct_staged import StagedDirectSort, scan_rotation_indices
    from .depth_meter import measure_direct_sort_depth
    from .params_registry import direct_sort_sign_cfg

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    N, ring, top = 128, 1 << 17, 12
    cfg = SignConfig(CompositeSignConfig(*direct_sort_sign_cfg(N)))
    depth = measure_direct_sort_depth(N, ring, cfg)["mult_depth"]
    per_op = args.path == "per_op"
    ctx = Context(CkksParams(ring_n=ring, mult_depth=depth, scale_bits=56, comp=2,
                             base_limbs=4, dnum=3,
                             ntt_impl="butterfly" if per_op else "auto"))
    keys = Keys.generate(ctx, seed=0)
    ev = Evaluator(ctx, keys)
    if per_op:
        keys.gen_rotation_keys(sorted(rotation_indices_direct_sort(N, ring)))
        srt = DirectSort(ev, N)
        sort = lambda ct: srt.sort(ct, SignFunc.CompositeSign, cfg)
    else:
        keys.gen_rotation_keys(sorted(scan_rotation_indices(N, ring)))
        sort = StagedDirectSort(ev, N, cfg)
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
