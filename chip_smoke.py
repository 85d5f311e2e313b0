"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (each failure raises, and the script exits non-zero):
  1. require a CUDA device; print the card's name and power limit;
  2. build the four-step NTT kernel K1 from `fhe_sorting_tpu_torch/csrc`;
  3. hold K1 against its plain PyTorch version on the card, bit for bit:
     ring 2^17 (n1=256, n2=512) on limbs of the N=128 chain and on a whole
     ciphertext, and ring 2^12; time both at the ring-2^17 ciphertext shape;
  4. drive the main path: Context(ring 2^17, depth from the depth meter) ->
     Keys -> Evaluator -> StagedDirectSort at N=128, a warm-up sort then a
     timed one, decrypt, and require max error < 0.01 against np.sort and a
     K1 launch count > 0 for the main path.
The last two lines are the kernels' JSON record and {"ok": true, ...}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch


def _sync():
    torch.cuda.synchronize()


def _time_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` runs, after a warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    _sync()
    return start.elapsed_time(end) / reps


def _check_k1(fs_ntt, ntt_plain, x, tabs, limbs, label: str) -> int:
    """K1 forward and inverse against the plain version; returns the max
    absolute difference (0 when bit-exact) and checks the round trip."""
    fwd = fs_ntt.four_step(x, tabs, limbs, inverse=False)
    inv = fs_ntt.four_step(fwd, tabs, limbs, inverse=True)
    _sync()
    err = max(int((fwd - ntt_plain(x, tabs, limbs, False)).abs().max()),
              int((inv - ntt_plain(fwd, tabs, limbs, True)).abs().max()))
    if err != 0 or not torch.equal(inv, x):
        raise AssertionError(f"K1 disagrees with its plain version ({label}): max |diff| {err}")
    print(f"# K1 == plain, forward and inverse, and intt(ntt(x)) == x: {label}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from fhe_sorting_tpu_torch.core import fs_ntt, ntt_mxu
    from fhe_sorting_tpu_torch.core import primes as primes_mod
    from fhe_sorting_tpu_torch.core.context import CkksParams, Context
    from fhe_sorting_tpu_torch.core.evaluator import Evaluator
    from fhe_sorting_tpu_torch.core.keys import Keys
    from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig
    from fhe_sorting_tpu_torch.parallel.direct_staged import (
        StagedDirectSort, scan_rotation_indices)
    from fhe_sorting_tpu_torch.utils.depth_meter import measure_direct_sort_depth
    from fhe_sorting_tpu_torch.utils.params_registry import direct_sort_sign_cfg

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # -- phase 2: build K1 ---------------------------------------------------
    t0 = time.time()
    fs_ntt.load()
    print(f"# K1 build + load: {time.time() - t0:.2f}s")
    if fs_ntt.build_log:
        print("# " + fs_ntt.build_log.strip().replace("\n", "\n# "))

    # -- phase 3: K1 against its plain version ---------------------------------
    N, ring = 128, 1 << 17
    cn, dg, df = direct_sort_sign_cfg(N)
    cfg = SignConfig(CompositeSignConfig(cn, dg, df))
    depth = measure_direct_sort_depth(N, ring, cfg)["mult_depth"]
    t0 = time.time()
    ctx = Context(CkksParams(ring_n=ring, mult_depth=depth, scale_bits=56, comp=2,
                             base_limbs=4, dnum=3), device=dev)
    ctx_s = time.time() - t0
    assert ctx.ntt_impl == "mxu", ctx.ntt_impl
    print(f"# context: ring 2^17, depth {depth}, Lq={ctx.num_q}, K={ctx.num_sp}, "
          f"{ctx_s:.1f}s")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tabs = ctx.tables
    n1, n2 = ntt_mxu.split_n(ring)

    def rand_planes(B, limbs):
        p = tabs.p[limbs]                          # [L, 1, 1]
        r = torch.randint(0, 1 << 62, (B, len(limbs), n1, n2), generator=gen,
                          device=dev, dtype=torch.int64)
        return torch.remainder(r, p)

    few = torch.tensor([0, 1, ctx.num_q - 1, ctx.num_q + ctx.num_sp - 1],
                       dtype=torch.int64, device=dev)
    err = _check_k1(fs_ntt, ntt_mxu.ntt_plain, rand_planes(2, few), tabs, few,
                    "ring 2^17, B=2, 4 limbs (active and special)")
    active = ctx.active_limbs(0)
    x = rand_planes(2, active)
    err = max(err, _check_k1(fs_ntt, ntt_mxu.ntt_plain, x, tabs, active,
                             f"ring 2^17, B=2, L={ctx.num_q} (a full ciphertext)"))
    small_primes = primes_mod.ntt_primes(4096, 28, 3)
    small = ntt_mxu.build_fs_tables(small_primes, 4096, dev)
    xs = torch.remainder(torch.randint(0, 1 << 62, (2, 3, 64, 64), generator=gen, device=dev),
                         small.p)
    err = max(err, _check_k1(fs_ntt, ntt_mxu.ntt_plain, xs, small, None, "ring 2^12, B=2, L=3"))

    k1_ms = _time_ms(lambda: fs_ntt.four_step(x, tabs, active, False), 10)
    plain_ms = _time_ms(lambda: ntt_mxu.ntt_plain(x, tabs, active, False), 3)
    k1_inv_ms = _time_ms(lambda: fs_ntt.four_step(x, tabs, active, True), 10)
    print(f"# K1 forward NTT [2, {ctx.num_q}, 2^17]: kernel {k1_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms; inverse kernel {k1_inv_ms:.3f} ms ({smi})")
    del x

    # -- phase 4: the main path ------------------------------------------------
    fs_ntt.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys(sorted(scan_rotation_indices(N, ring)))
    ev = Evaluator(ctx, keys)
    srt = StagedDirectSort(ev, N, cfg)
    _sync()
    keys_s = time.time() - t0
    vals = np.random.default_rng(0).permutation(N) / N + 0.5 / N
    ct = keys.encrypt(vals)

    def sort():
        t0 = time.time()
        rank = srt.construct_rank(ct)
        _sync()
        t1 = time.time()
        out = srt.index_check(rank, ct)
        _sync()
        return out, t1 - t0, time.time() - t1

    out, w_cr, w_ic = sort()
    print(f"# warm-up sort: constructRank {w_cr:.2f}s, rotationIndexCheck {w_ic:.2f}s")
    srt.verbose = True
    out, t_cr, t_ic = sort()
    launches = fs_ntt.launches
    got = keys.decrypt(out, N)
    sort_err = float(np.abs(got - np.sort(vals)).max())
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"# setup: context {ctx_s:.2f}s, keys ({len(keys.rot)} rotation + relin) "
          f"{keys_s:.2f}s")
    print(f"# sort N={N}: constructRank {t_cr:.3f}s, rotationIndexCheck {t_ic:.3f}s, "
          f"total {t_cr + t_ic:.3f}s; output level {out.level}, {out.num_limbs} limbs")
    print(f"# max sort error {sort_err:.3e}; K1 launches on the main path {launches}; "
          f"peak device memory {peak_gb:.2f} GiB ({smi})")
    print(f"# stage calls: { {name: st.calls for name, st in srt.stages.items()} }")
    if not np.all(np.isfinite(got)) or got.shape != (N,):
        raise AssertionError("sort output is not N finite values")
    if not sort_err < 0.01:
        raise AssertionError(f"sort error {sort_err} >= 0.01")
    if launches <= 0:
        raise AssertionError("the main path launched K1 no time")

    print(json.dumps({"kernels": [{
        "name": "fs_ntt (four-step NTT, K1)", "route": "cuda",
        "source": "fhe_sorting_tpu_torch/csrc/fs_ntt.cu",
        "replaces": "fhe_sorting_tpu/core/pallas_fs_ntt.py:97",
        "launches": launches, "max_abs_err": err,
        "ms": k1_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
