"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (each failure raises, and the script exits non-zero):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels K1 (four-step NTT on the s8 tensor cores) and K2
     (butterfly NTT in one pass through a thread-block cluster) from
     `fhe_sorting_tpu_torch/csrc`, one nvcc each, started together;
  3. hold K1 against its plain PyTorch version on the card, bit for bit:
     ring 2^17 (n1=256, n2=512) on limbs of the N=128 chain and on a whole
     ciphertext, and ring 2^12; time both at the ring-2^17 ciphertext shape;
  4. hold K2 against its plain version the same way (ring 2^17 on four limbs
     and on a whole ciphertext, ring 2^12, ring 2^10) and against K1 on the
     same planes; time K2, K1 and the plain butterfly, forward and inverse,
     and both kernels at one small transform of the sort, [1, K, 2^17] on the
     special limbs (ModDown's inverse NTT); print how many clusters (planes)
     of K2 the card holds at once;
  5. drive the staged path: Context(ring 2^17, depth from the depth meter)
     -> Keys -> Evaluator -> StagedDirectSort at N=128, eagerly
     (`graphs=False`) and on CUDA graphs (the default: each stage one
     captured graph, `parallel/whole_graph.py`), from the same ciphertext and
     keys: each a warm-up sort (on graphs: eager runs and captures) then a
     timed one, decrypt, and require max error < 0.01 against np.sort, K1
     launch counts > 0 (on graphs, the replays' tallies) and equal for both,
     and output planes equal; print each sort's seconds, the captures'
     seconds, the graphs, the peaks, and the roofline of the sort on graphs,
     phase by phase: the share of the speed of light on `roofline.H100` of
     one sort's op tallies (`phase_stats`) and the unit that bounds it;
 15. (run right after phase 5, on its K1 context and keys) the gather-free
     automorphism (`core/auto_affine.py`): the microbenchmark
     (`utils/auto_microbench.py`) of the gather, `torch.roll` and the affine
     path at [2, Lq, 2^17] and on one hoisted operand [3, Lq+K, 2^17], the
     affine path equal to the gather for rotations 1, -1, 64 and
     conjugation; the staged N=128 sort on an evaluator built with
     FHE_AFFINE_AUTO=1, eagerly and on CUDA graphs (a warm-up, then a timed
     sort each), K1 launched, K2 not, output planes equal to phase 5's
     gather sort, max error < 0.01, peak within the reckoning with the
     affine tables; then, on butterfly contexts (K2 only): the experiment
     ladder (`utils/experiments.py`, DirectSort N=4 and 8, three trials,
     ring 2048, each row max error < 0.01) and its aggregate, the decrypt
     probe (`utils/probe_direct.py`, N=16, ring 2^12, sort error < 0.01)
     and the rotation bench (`utils/rotation_bench.py`, ring 2^12);
  6. drive the per-op path the same way on a butterfly context:
     DirectSort(ev, 128).sort over the full key set, and require K2
     launches > 0 and K1 launches == 0 for the timed sort.
 14. (run after phase 7, on phase 6's butterfly context) ScanDirectSort, each
     sort phase a few CUDA graphs with the per-batch body replayed: N=128 at
     ring 2^17 (one batch) and N=64 at ring 2^12 (two batches, so the body is
     replayed with its carry), each on its scan key set, eagerly and on
     graphs from the same ciphertext: output planes equal, max error < 0.01,
     K2 launches > 0 and K1 launches == 0 in the sort of replays, and equal
     to the eager sort's;
  7. serve on files (the slice's main path): a client writes the flagship
     butterfly context, the per-op rotation key set and an encrypted input
     into a fresh temporary directory; the secret-free server runs through
     `fhe_sorting_tpu_torch.serving.sort_server.main`; the client decrypts
     `out.npz`, and the error against np.sort must be below 0.01.  The input
     is the tie-free vector of phases 5 and 6: the rank sort breaks no ties
     (`tests/test_torch_direct_sort.py` pins what a tied input gives);
  8. one bootstrap at ring 2^17 (comp=2, first_mod_bits=30, level budget
     (3,3), every rotation through a RotationComposer with a lazy key pool):
     the uniform-ternary-secret shape, a first refresh on an empty plaintext
     memo (the bootstrap's time) and a second on a memo that holds every
     plaintext, max error < 1e-2 on 2^16 values in [0, 1];
  9. BitonicSort with bootstrapping at N=8, depth 42, sparse secret, max error
     < 0.01 and at least one bootstrap fired;
 10. MEHP24 at N=64 (one 64 x 64 matrix in 4096 slots), depth 43, max error
     < 0.01;
     the sign characterizer: CompositeSign(3,3,2) swept at ring 2^12;
 11. the k-way sorting network, k=2 and N=16, at ring 2^17 under a uniform
     ternary secret within the 128-bit logQP budget, with real bootstraps mid-
     sort (`fhe_sorting_tpu_torch.utils.kway_run`): max error < 0.01 and at
     least one bootstrap fired; then one five-sorter stage (k=5, N=5) on the
     same context and keys, max error < 0.01;
 12. the staged N>256 regimes at the reference's size, N=512 over two
     256-wide tiles (`utils.large_sort.staged_hybrid`, `staged_mehp24`):
     the staged hybrid DirectSort (depth 48) and the staged MEHP24 triangle
     (depth 46), on CUDA graphs, each max error < 0.01;
 13. the multi-device sorts on a one-rank NCCL world (`file://` store in a
     temporary directory): ShardedDirectSort at N=1024 (depth metered on the
     sharded class, 20 rotation and 16 batch-offset keys) after a warm-up,
     a limb-parallel mult + rescale + rotate on a (1 x 1) mesh bit-equal to
     the plain evaluator, and ShardedMehp24 at N=512 over two 256 x 256
     parts on phase 12's MEHP24 chain; each sort max error < 0.01.
 16. (last) the entry points of the system's own measurements, each as a
     user runs it: `python -m fhe_sorting_tpu_torch.utils.bench --n 128
     --trials 1` as a subprocess (the staged N=128 sort on K1 and graphs:
     `bench.py`'s keys, error < 0.01, within the 128-bit logQP budget, a
     share of the speed of light in (0, 105)%, K1 launched in the timed
     sort); `utils/ntt_bench.py` at its defaults ([2, 40, 2^16]: K2, the
     plain four-step and K1 bit-equal to the plain butterfly, then a
     rotation and a multiplication on K1); `utils/run_bootstrap.py` at its
     defaults (ring 2^14, sparse secret, level budget 3, on K1), max error
     < 1e-2.
Phases 7-14 run butterfly contexts: each must launch K2 and never K1, with
the counts set to 0 just before and read just after.  Every phase from 5 on
reckons its memory first (`hbm_budget.check_phase`, with the path's
measured working set) and fails where its measured peak exceeds that
budget.
The last two lines are the kernels' JSON record and {"ok": true, ...}.

Bounds in the JSON record: `bound_ms` is the least time the card could take
for the function, a negacyclic NTT of the planes, whatever algorithm a kernel
chose (`fhe_sorting_tpu_torch.utils.roofline.ntt_butterfly` on `H100`): the
larger of the bytes it must move (data in, data out, one [L, n] twiddle
table) over the card's 3.35 TB/s and the (n/2) log2(n) butterflies a plane,
ten 32-bit integer operations each, over 67 T op/s (the published float32
rate of the CUDA cores, a multiply-add counted as two; no separate integer
rate is published, and integer multiply-add runs no faster).  K1 and K2
compute the same function, so they share one bound.  `form_ops_ms` is the
arithmetic of the kernel's own algorithm over the same rate: the four-step
form of K1 does n (n1 + n2) multiply-adds a plane, far more than the function
needs, and that excess is the kernel's to answer for, not part of its bound.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N, RING = 128, 1 << 17


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


def _check(name: str, kernel, plain, x, label: str) -> int:
    """kernel(x, inverse) forward and inverse against plain(x, inverse);
    returns the max absolute difference (0 when bit-exact) and checks the
    round trip."""
    fwd = kernel(x, False)
    inv = kernel(fwd, True)
    _sync()
    err = max(int((fwd - plain(x, False)).abs().max()),
              int((inv - plain(fwd, True)).abs().max()))
    if err != 0 or not torch.equal(inv, x):
        raise AssertionError(f"{name} disagrees with its plain version ({label}): max |diff| {err}")
    print(f"# {name} == plain, forward and inverse, and intt(ntt(x)) == x: {label}")
    return err


def _rand_residues(gen, shape, p):
    return torch.remainder(torch.randint(0, 1 << 62, shape, generator=gen, device=p.device,
                                         dtype=torch.int64), p)


def _ops_ms(ops: float) -> float:
    from fhe_sorting_tpu_torch.utils.roofline import H100

    return ops / H100.int_ops_s * 1e3


def _ntt_bound(planes: int, limbs: int, n: int):
    """((ms, "bytes" or "operations"), ms of the operations alone): the
    least time for a negacyclic NTT of `planes` int64 planes of n residues
    over `limbs` primes, `roofline.ntt_butterfly` on `roofline.H100`."""
    from fhe_sorting_tpu_torch.utils.roofline import H100, ntt_butterfly

    cost = ntt_butterfly(n, limbs, planes // limbs)
    by = "bytes" if cost.bound(H100) == "HBM" else "operations"
    return (cost.sol_seconds(H100) * 1e3, by), _ops_ms(cost.int_ops)


def _run_sort(label, keys, ct, vals, sort, phase1, phase2, counters, smi, report):
    """A warm-up sort of `ct`, then a timed one, both through the entry point
    `sort`; every kernel's count is set to 0 just before the timed sort and
    read just after, and the error is that sort's; the peak memory is taken
    over both (held to `report`'s budget).  A third sort, uncounted, runs the
    entry point's two phases by hand for their seconds.  Returns (counts,
    seconds, (constructRank seconds, rotationIndexCheck seconds), output,
    (warm-up seconds, warm-up peak GiB, timed peak GiB))."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sort(ct)
    _sync()
    warm_s = time.time() - t0
    warm_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"# {label}: warm-up sort {warm_s:.2f}s, peak {warm_peak:.2f} GiB")
    for mod in counters:
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = sort(ct)
    _sync()
    total = time.time() - t0
    counts = [mod.launches for mod in counters]
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = keys.decrypt(out, N)
    err = float(np.abs(got - np.sort(vals)).max())
    print(f"# {label} N={N}: sort {total:.3f}s; output level {out.level}, "
          f"{out.num_limbs} limbs")
    print(f"# {label}: max sort error {err:.3e} ({smi})")
    _check_memory(label, report, max(peak, warm_peak), smi)
    if not np.all(np.isfinite(got)) or got.shape != (N,):
        raise AssertionError(f"{label}: sort output is not N finite values")
    if not err < 0.01:
        raise AssertionError(f"{label}: sort error {err} >= 0.01")
    t0 = time.time()
    rank = phase1(ct)
    _sync()
    t1 = time.time()
    again = phase2(rank, ct)
    _sync()
    t2 = time.time()
    if not torch.equal(again.data, out.data):
        raise AssertionError(f"{label}: the two phases by hand differ from the entry point")
    print(f"# {label}, a further sort by phase: constructRank {t1 - t0:.3f}s, "
          f"rotationIndexCheck {t2 - t1:.3f}s, total {t2 - t0:.3f}s")
    return counts, total, (t1 - t0, t2 - t1), out, (warm_s, warm_peak, peak)


def _check_memory(label, report, peak_gib, smi):
    """Print a phase's measured peak beside what `check_phase` reckoned, and
    fail where it exceeds the budget the reckoning was made against."""
    from fhe_sorting_tpu_torch.utils import hbm_budget

    print(f"# {label}: peak device memory {peak_gib:.2f} GiB measured, {report['used_gib']} GiB "
          f"reckoned ({report['n_rot_keys']} rotation keys + relin, {report['n_cts']} + "
          f"{report['work_cts']} ciphertexts), budget {report['budget_gib']} GiB ({smi})")
    hbm_budget.check_peak(report, peak_gib)


def _release():
    """Return the device memory of everything no longer referenced."""
    gc.collect()
    torch.cuda.empty_cache()


def _counted(counters, fn):
    """fn() with every kernel's count set to 0 just before and read just
    after (synchronised); returns (result, seconds, counts)."""
    for mod in counters:
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    _sync()
    secs = time.time() - t0
    return out, secs, [mod.launches for mod in counters]


def _require_k2_only(label, counts):
    k1, k2 = counts
    print(f"# {label}: K2 launches {k2}, K1 launches {k1}")
    if k2 <= 0 or k1 != 0:
        raise AssertionError(f"{label}: a butterfly context must launch K2 and not K1")
    return k2


def _phase7_serve(ctx2, keys, counters, smi):
    """Serve the tie-free vector of phases 5 and 6 from files through the
    server's entry point, and hold the decrypted output to max error < 0.01;
    returns the K2 launches of the server's run."""
    from fhe_sorting_tpu_torch.core import serialize
    from fhe_sorting_tpu_torch.core.keys import Keys
    from fhe_sorting_tpu_torch.serving import sort_server
    from fhe_sorting_tpu_torch.utils import hbm_budget

    x = np.random.default_rng(0).permutation(N) / N + 0.5 / N
    tmp = tempfile.mkdtemp(prefix="fhe_serve_")
    try:
        free_gb = shutil.disk_usage(tmp).free / 2**30
        need_gb = (len(keys.rot) + 1) * 2 * 3 * (ctx2.num_q + ctx2.num_sp) * RING * 4 / 2**30
        print(f"# serve: temporary directory on a file system with {free_gb:.1f} GiB free; "
              f"the key file needs {need_gb:.2f} GiB")
        if free_gb < need_gb * 1.05:
            raise RuntimeError("serve: not enough free space for the key file")
        path = {k: os.path.join(tmp, v) for k, v in
                dict(cc="cc.json", keys="keys.npz", inp="in.npz", out="out.npz").items()}
        # -- the client: context and evaluation keys
        serialize.save_context(path["cc"], ctx2)
        t0 = time.time()
        serialize.save_eval_keys(path["keys"], keys)
        write_keys_s = time.time() - t0
        # one key written both ways: why the archive is stored, not deflated
        one = {"kb": serialize._to_u32(keys.relin.kb), "ka": serialize._to_u32(keys.relin.ka)}
        t0 = time.time()
        np.savez(os.path.join(tmp, "one_stored.npz"), **one)
        t1 = time.time()
        np.savez_compressed(os.path.join(tmp, "one_deflated.npz"), **one)
        t2 = time.time()
        sz = [os.path.getsize(os.path.join(tmp, f"one_{k}.npz")) / 2**20 for k in ("stored", "deflated")]
        print(f"# serve: one key-switch key to a file: np.savez {t1 - t0:.2f}s, {sz[0]:.0f} MiB; "
              f"np.savez_compressed {t2 - t1:.2f}s, {sz[1]:.0f} MiB ({smi})")
        del one
        n_rot = len(keys.rot)
        # the server holds the key set, its input and the per-op sort's
        report = hbm_budget.check_phase(ctx2, n_rot, 4, work_cts=hbm_budget.WORK_CTS["direct_per_op"],
                                        label="serve")
        # what decrypts the output stays with the client; every evaluation
        # key, and the device memory they hold, goes
        client = Keys(ctx=ctx2, s_coeffs=keys.s_coeffs, s_eval=keys.s_eval, pk=keys.pk)
        keys.relin, keys.rot = None, {}
        del keys
        _release()
        print(f"# serve: {n_rot} rotation keys + relin written in {write_keys_s:.2f}s; cc.json "
              f"{os.path.getsize(path['cc'])} B, keys.npz {os.path.getsize(path['keys']) / 2**20:.0f} "
              f"MiB ({smi})")

        # -- the server, through its normal entry point; its loaders are
        # wrapped to be timed and to show the key set it holds
        seen, secs = {}, {}

        def timed(name, fn):
            def wrapper(*a, **kw):
                t0 = time.time()
                out = fn(*a, **kw)
                _sync()
                secs[name] = time.time() - t0
                seen[name] = out
                return out
            return wrapper

        names = ("load_context", "load_eval_keys", "load_ciphertext", "save_ciphertext")
        originals = {name: getattr(sort_server, name) for name in names}
        serialize.save_ciphertext(path["inp"], client.encrypt(x))
        for name, fn in originals.items():
            setattr(sort_server, name, timed(name, fn))
        try:
            _, total_s, counts = _counted(counters, lambda: sort_server.main([
                "--cc", path["cc"], "--keys", path["keys"], "--input", path["inp"],
                "--output", path["out"], "--n", str(N), "--algo", "direct"]))
        finally:
            for name, fn in originals.items():
                setattr(sort_server, name, fn)
        peak = torch.cuda.max_memory_allocated() / 2**30
        server_keys = seen["load_eval_keys"]
        if server_keys.s_eval is not None or server_keys.s_coeffs is not None:
            raise AssertionError("serve: the server's key set holds a secret")
        if len(server_keys.rot) != n_rot or seen["load_context"].ntt_impl != "butterfly":
            raise AssertionError("serve: the files did not carry the keys or ntt_impl")
        sort_s = total_s - sum(secs.values())
        seen.clear()
        del server_keys
        _release()
        # -- the client again
        out = serialize.load_ciphertext(path["out"], ctx2.device)
        got = client.decrypt(out, N)
        err = float(np.abs(got - np.sort(x)).max())
        print(f"# serve N={N}, ring 2^17: load context {secs['load_context']:.2f}s, load keys to "
              f"the device {secs['load_eval_keys']:.2f}s, sort {sort_s:.2f}s, write output "
              f"{secs['save_ciphertext']:.2f}s; in.npz {os.path.getsize(path['inp']) / 2**20:.1f} "
              f"MiB, out.npz {os.path.getsize(path['out']) / 2**20:.1f} MiB; max sort error "
              f"{err:.3e} ({smi})")
        _check_memory("serve", report, peak, smi)
        if not np.all(np.isfinite(got)) or got.shape != (N,):
            raise AssertionError("serve: output is not N finite values")
        if not err < 0.01:
            raise AssertionError(f"serve: sort error {err} >= 0.01")
        return _require_k2_only("serve", counts)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _boot_env(depth, hamming, budget, smi, label, pt_cache_bytes=None, n_cts=4):
    """Context, keys (conjugation + the power-of-two basis), evaluator,
    composer and Bootstrapper of one bootstrap configuration at ring 2^17 on
    a butterfly context, built as `utils/run_bootstrap.py` builds its own
    (with its EvalMod shape for the secret: hamming 64 or, with None, uniform
    ternary); the memory is reckoned before anything is allocated.
    `pt_cache_bytes` bounds the evaluator's plaintext memo (None: its
    default)."""
    from fhe_sorting_tpu_torch.utils import run_bootstrap

    t0 = time.time()
    ctx = run_bootstrap.context(RING, depth, hamming, ntt_impl="butterfly")
    logqp = sum(np.log2(float(p)) for p in ctx.all_primes)
    report = run_bootstrap.reckon(ctx, label, pt_cache_bytes, n_cts)
    print(f"# {label}: depth {depth}, Lq={ctx.num_q}, K={ctx.num_sp}, logQP={logqp:.0f}; "
          f"reckoned before allocating: {report}")
    keys, ev, rot, bs = run_bootstrap.assemble(ctx, budget, run_bootstrap.shape(RING, hamming is None),
                                               pt_cache_bytes)
    _sync()
    print(f"# {label}: context, keys ({len(keys.rot)} resident) and the factored transforms "
          f"{time.time() - t0:.1f}s; {len(bs.required_rotations())} distinct BSGS rotations, "
          f"{sum(len(lt.diags) for lt in bs.c2s)} C2S diagonals")
    return ctx, keys, ev, rot, bs, report


def _phase8_bootstrap(counters, smi):
    """Two refreshes of 2^16 values in [0, 1].  The first, on an empty
    plaintext memo, is the bootstrap's time: it encodes every diagonal on the
    host, as every refresh does under the evaluator's default memo, which holds
    a fraction of one refresh's plaintexts.  The second shows what a memo
    that holds them all (24 GiB here) saves.  The uniform-ternary-secret
    shape; the second refresh must meet max error < 1e-2.  Returns its K2
    launches."""
    # the refresh ends at level 30 (scale degree 2): depth 33 leaves two levels
    depth = 33
    ctx, keys, ev, rot, bs, report = _boot_env(depth, None, (3, 3), smi,
                                               "bootstrap (uniform ternary secret)",
                                               pt_cache_bytes=24 << 30)
    nh = RING // 2
    z = np.random.default_rng(3).uniform(0, 1.0, nh)
    ct_low = ev.level_reduce(keys.encrypt(z), depth - 1)
    t0 = time.time()
    bs.bootstrap(ct_low)
    _sync()
    cold_s = time.time() - t0
    cold_pt = dict(ev.pt_stats)
    print(f"# bootstrap ring 2^17, {nh} slots, first refresh (plaintext memo empty): {cold_s:.2f}s; "
          f"memo {cold_pt['misses']} misses, {cold_pt['hits']} hits, {cold_pt['encode_s']:.2f}s of "
          f"host encoding, {ev._pt_cache_used / 2**30:.2f} GiB held of "
          f"{ev.pt_cache_bytes / 2**30:.0f} GiB ({smi})")
    # seconds by stage of the second refresh (a synchronise after each)
    stage_s = {"ModRaise": 0.0, "C2S": 0.0, "EvalMod": 0.0, "S2C": 0.0}

    def staged(name, fn):
        def wrapper(*a, **kw):
            _sync()
            t0 = time.time()
            out = fn(*a, **kw)
            _sync()
            stage_s[name] += time.time() - t0
            return out
        return wrapper

    bs._mod_raise = staged("ModRaise", bs._mod_raise)
    bs._eval_mod = staged("EvalMod", bs._eval_mod)
    for lt in bs.c2s:
        lt.apply = staged("C2S", lt.apply)
    for chain in bs._s2c_cache.values():
        for lt in chain:
            lt.apply = staged("S2C", lt.apply)
    before = (rot.stats.rotations, rot.stats.composed, rot.stats.lazy_keygens)
    ev.pt_stats.update(hits=0, misses=0, encode_s=0.0)
    out, boot_s, counts = _counted(counters, lambda: bs.bootstrap(ct_low))
    peak = torch.cuda.max_memory_allocated() / 2**30
    try:
        got = keys.decrypt(out, nh)
    except OverflowError:            # noise beyond the modulus: an error of its own size
        got = np.full(nh, np.inf)
    err = np.abs(got - z)
    rots, composed, lazy = (a - b for a, b in zip(
        (rot.stats.rotations, rot.stats.composed, rot.stats.lazy_keygens), before))
    print(f"# bootstrap, second refresh (memo holds every plaintext): {boot_s:.2f}s against "
          f"{cold_s:.2f}s; level {ct_low.level} -> {out.level} (scale degree {out.sdeg}) of "
          f"{depth}; max error {err.max():.3e}, mean {err.mean():.3e} ({smi})")
    print("# bootstrap by stage (second refresh): "
          + ", ".join(f"{k} {v:.2f}s" for k, v in stage_s.items())
          + f"; rotations {rots}, composed {composed}, lazy keygens {lazy}")
    print(f"# bootstrap: plaintext memo {ev.pt_stats['misses']} misses, {ev.pt_stats['hits']} hits, "
          f"{ev.pt_stats['encode_s']:.2f}s of host encoding in the second refresh ({smi})")
    _check_memory("bootstrap", report, peak, smi)
    if not out.level + (out.sdeg == 2) <= depth - 2:
        raise AssertionError(f"bootstrap: fewer than two levels left (level {out.level})")
    if not out.level < ct_low.level:
        raise AssertionError("bootstrap: the level was not refreshed")
    if not err.max() < 1e-2:
        raise AssertionError(f"bootstrap: max error {err.max()} >= 1e-2")
    return _require_k2_only("bootstrap", counts)


def _phase9_bitonic(counters, smi, n=8):
    """BitonicSort with bootstrapping: sparse secret, dg=df=2, depth 42 (the
    published recipe's 40 is sized for a budget-(2,2) refresh that ends near
    level 20; the budget-(3,3) refresh used here ends at level 24)."""
    from fhe_sorting_tpu_torch.models.bitonic import BitonicSort
    from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig, SignFunc

    depth = 42
    # the evaluator's default plaintext memo: one refresh's plaintexts at this
    # depth are over 24 GiB, and a memo smaller than that cyclic working set
    # never hits, so a larger one would only take memory
    ctx, keys, ev, rot, bs, report = _boot_env(depth, 64, (3, 3), smi,
                                               "bitonic (sparse secret, hamming 64)")
    keys.gen_rotation_keys([-(1 << i) for i in range(n.bit_length() - 1)])
    fired = []

    def bootstrap_fn(ct):
        fired.append(ct.level)
        return bs.bootstrap(ct, msg_scale_down=2.0)

    # the refresh ends at level 24 (scale degree 2), one compare-and-swap stage
    # costs at most 15 levels, and the next refresh spends two more on its
    # pre-scale before it drops to the bottom: 24 + 15 + 2 = 41
    srt = BitonicSort(ev, n, normalize=1.0, bootstrap_fn=bootstrap_fn, bootstrap_level=20,
                      rot=rot)
    cfg = SignConfig(CompositeSignConfig(3, 2, 2), mult_depth=depth)
    x = np.random.default_rng(4).permutation(n) / n + 0.5 / n
    out, secs, counts = _counted(
        counters, lambda: srt.sort(keys.encrypt(x, slots=n), SignFunc.CompositeSign, cfg))
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = keys.decrypt(out, n)
    err = float(np.abs(got - np.sort(x)).max())
    print(f"# bitonic N={n}, ring 2^17: {secs:.2f}s, bootstraps fired at levels {fired}, output "
          f"level {out.level}; max sort error {err:.3e}; plaintext memo {ev.pt_stats}; "
          f"lazy keygens {rot.stats.lazy_keygens} ({smi})")
    _check_memory("bitonic", report, peak, smi)
    if not np.all(np.isfinite(got)) or got.shape != (n,):
        raise AssertionError("bitonic: output is not N finite values")
    if len(fired) < 1:
        raise AssertionError("bitonic: no bootstrap fired")
    if not err < 0.01:
        raise AssertionError(f"bitonic: sort error {err} >= 0.01")
    return _require_k2_only("bitonic", counts)


def _phase10_mehp24(counters, smi, n=64):
    """MEHP24 at one n x n matrix, driven from Python."""
    from fhe_sorting_tpu_torch.core.context import CkksParams, Context
    from fhe_sorting_tpu_torch.core.evaluator import Evaluator
    from fhe_sorting_tpu_torch.core.keys import Keys
    from fhe_sorting_tpu_torch.models.mehp24 import Mehp24Sort
    from fhe_sorting_tpu_torch.models.mehp24.utils import rotation_indices_mehp24
    from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig, SignFunc
    from fhe_sorting_tpu_torch.utils import hbm_budget
    from fhe_sorting_tpu_torch.utils.params_registry import MEHP24_DEPTH, direct_sort_sign_cfg

    depth = MEHP24_DEPTH[n] + 2
    t0 = time.time()
    ctx = Context(CkksParams(ring_n=RING, mult_depth=depth, scale_bits=56, comp=2, base_limbs=4,
                             ntt_impl="butterfly"))
    pow2 = {1 << i for i in range(RING.bit_length() - 2)}
    steps = sorted(rotation_indices_mehp24(n) | pow2 | {-s for s in pow2})
    report = hbm_budget.check_phase(ctx, len(steps), 6, work_cts=hbm_budget.WORK_CTS["mehp24"],
                                    label=f"MEHP24 N={n}")
    print(f"# mehp24: depth {depth}, Lq={ctx.num_q}, K={ctx.num_sp}; reckoned before "
          f"allocating: {report}")
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys(steps)
    ev = Evaluator(ctx, keys)
    _sync()
    print(f"# mehp24: context and keys ({len(keys.rot)} rotation + relin) {time.time() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    srt = Mehp24Sort(ev, n, sub_length=n)
    _, dg, df = direct_sort_sign_cfg(n)
    cfg = SignConfig(CompositeSignConfig(3, dg, df))
    x = np.random.default_rng(5).permutation(n) / n + 0.5 / n
    padded = np.zeros(n * n)
    padded[:n] = x
    out, secs, counts = _counted(
        counters, lambda: srt.sort(keys.encrypt(padded, slots=n * n), SignFunc.CompositeSign, cfg))
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = keys.decrypt(out, n)
    err = float(np.abs(got - np.sort(x)).max())
    print(f"# mehp24 N={n} ({n * n} slots), ring 2^17: {secs:.2f}s, output level {out.level}; "
          f"max sort error {err:.3e}; rotations {srt.rot.stats.rotations} ({smi})")
    _check_memory("mehp24", report, peak, smi)
    if not np.all(np.isfinite(got)) or got.shape != (n,):
        raise AssertionError("mehp24: output is not N finite values")
    if not err < 0.01:
        raise AssertionError(f"mehp24: sort error {err} >= 0.01")
    return _require_k2_only("mehp24", counts)


def _characterizer_line(counters, smi):
    """The sign characterizer's sweep of CompositeSign(3,3,2) at ring 2^12 on
    a butterfly context (keys from seed 0, as the characterizer makes)."""
    from fhe_sorting_tpu_torch.core.context import CkksParams, Context
    from fhe_sorting_tpu_torch.core.keys import Keys
    from fhe_sorting_tpu_torch.utils.sign_characterizer import characterize

    ctx = Context(CkksParams(ring_n=1 << 12, mult_depth=(3 + 2) * 3 + 4, ntt_impl="butterfly"))
    keys = Keys.generate(ctx, seed=0)
    m, secs, counts = _counted(counters, lambda: characterize(3, 3, 2, keys=keys))
    print(f"# sign characterizer, ring 2^12: {json.dumps(m)}; sweep {secs:.2f}s ({smi})")
    if m["working_precision"] is None:
        raise AssertionError("characterizer: no input magnitude met the threshold")
    return _require_k2_only("characterizer", counts)


def _phase11_kway(counters, smi, n=16):
    """The k-way network, k=2, at ring 2^17 under a uniform ternary secret
    (`kway_run.build`), then one five-sorter stage on its context and keys."""
    from fhe_sorting_tpu_torch.models.kway import KWaySorter
    from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig, SignFunc
    from fhe_sorting_tpu_torch.utils import hbm_budget, kway_run

    t0 = time.time()
    run = kway_run.build(n)
    _sync()
    setup_s = time.time() - t0
    budget = kway_run.LOGQP_128[RING]
    print(f"# k-way N={n}: ring 2^17, depth {kway_run.DEPTH}, Lq={run.ctx.num_q}, "
          f"K={run.ctx.num_sp}, uniform ternary secret, logQP {run.logqp:.1f} against the "
          f"128-bit budget {budget}; reckoned before allocating: {run.report}; plaintext memo "
          f"{run.memo}; setup {setup_s:.1f}s ({len(run.keys.rot)} keys resident + lazy pool "
          f"{kway_run.LAZY_KEYS}) ({smi})")
    if not run.logqp <= budget:
        raise AssertionError(f"k-way: logQP {run.logqp} over the budget {budget}")
    ct = run.keys.encrypt(run.vals, slots=n)
    out, secs, counts = _counted(
        counters, lambda: run.sorter.sort(ct, SignFunc.CompositeSign, run.cfg))
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = run.keys.decrypt(out, n)
    err = float(np.abs(got - np.sort(run.vals)).max())
    st, pt = run.rot.stats, run.ev.pt_stats
    boot_s = sum(f["s"] for f in run.fired)
    print(f"# k-way N={n}: sort {secs:.2f}s, of it {len(run.fired)} bootstraps {boot_s:.2f}s; "
          f"per refresh (level, s, lazy keygens, memo misses): {kway_run.describe(run.fired)}; "
          f"output level {out.level}; max sort error {err:.3e} ({smi})")
    print(f"# k-way: rotations {st.rotations}, composed {st.composed}, lazy keygens "
          f"{st.lazy_keygens}; plaintext memo {pt['misses']} misses, "
          f"{pt['hits']} hits, {pt['encode_s']:.2f}s of host encoding, "
          f"{run.ev._pt_cache_used / 2**30:.2f} GiB held; peak device memory {peak:.2f} GiB "
          f"measured against the {run.report['budget_gib']} GiB budget, {run.report['used_gib']} "
          f"GiB reckoned for keys, ciphertexts and a refresh ({smi})")
    hbm_budget.check_peak(run.report, peak)
    if not np.all(np.isfinite(got)) or got.shape != (n,):
        raise AssertionError("k-way: output is not N finite values")
    if len(run.fired) < 1:
        raise AssertionError("k-way: no bootstrap fired")
    if not err < 0.01:
        raise AssertionError(f"k-way: sort error {err} >= 0.01")
    k2 = _require_k2_only("k-way", counts)

    # one five-sorter stage: k=5, N=5 in 8 slots, on the chain's depth alone
    x5 = np.array([0.9, 0.1, 0.5, 0.7, 0.3])
    pad = np.zeros(8)
    pad[:5] = x5
    ct5 = run.keys.encrypt(pad, slots=8)
    srt5 = KWaySorter(run.ev, 5, 1)
    out5, secs5, counts5 = _counted(counters, lambda: srt5.sort(
        ct5, SignFunc.CompositeSign, SignConfig(CompositeSignConfig(3, 3, 2))))
    got5 = run.keys.decrypt(out5, 5)
    err5 = float(np.abs(got5 - np.sort(x5)).max())
    print(f"# k-way five-sorter stage (k=5, N=5): {secs5:.2f}s, output level {out5.level}; max "
          f"sort error {err5:.3e} ({smi})")
    if not np.all(np.isfinite(got5)) or not err5 < 0.01:
        raise AssertionError(f"k-way five-sorter: sort error {err5} >= 0.01")
    return k2 + _require_k2_only("k-way five-sorter", counts5)


def _phase12_staged_large(counters, smi, n=512):
    """The staged hybrid DirectSort and the staged MEHP24 triangle over two
    tiles, as `large_sort.staged_hybrid` and `staged_mehp24` configure them."""
    from fhe_sorting_tpu_torch.utils import large_sort

    k2 = 0
    for label, build in (("staged hybrid", large_sort.staged_hybrid),
                         ("staged MEHP24", large_sort.staged_mehp24)):
        t0 = time.time()
        ctx, keys, sort, info = build(n)
        _sync()
        setup_s = time.time() - t0
        x = np.random.default_rng(6).permutation(n) / n + 0.5 / n
        pad = np.zeros(info["slots"])
        pad[:n] = x
        ct = keys.encrypt(pad, slots=info["slots"])
        out, secs, counts = _counted(counters, lambda: sort(ct))
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = keys.decrypt(out, n)
        err = float(np.abs(got - np.sort(x)).max())
        phases = ", ".join(f"{k} {v:.2f}s" for k, v in info["phase_s"].items())
        print(f"# {info['what']}, ring 2^17: depth {info['depth']}, Lq={ctx.num_q}, "
              f"K={ctx.num_sp}, logQP {info['logqp']:.1f}; setup {setup_s:.1f}s; sort "
              f"{secs:.2f}s{f' ({phases})' if phases else ''}, output level {out.level}; max sort "
              f"error {err:.3e} ({smi})")
        _check_memory(label, max(info["reports"], key=lambda r: r["used_gib"]), peak, smi)
        if not np.all(np.isfinite(got)) or not err < 0.01:
            raise AssertionError(f"{label}: sort error {err} >= 0.01")
        k2 += _require_k2_only(label, counts)
        del ctx, keys, sort, info, ct, out
        _release()
    return k2


def _phase13_sharded(counters, smi, n=1024, n_mehp=512):
    """The multi-device sorts on a one-rank NCCL world on this card: the
    sharded DirectSort at N=1024 and the sharded MEHP24 triangle at N=512,
    each against the budget its memory was reckoned with, and a limb-parallel
    mult + rescale + rotate on a (1 x 1) mesh bit-equal to the plain
    evaluator.  Returns the K2 launches of the three."""
    import torch.distributed as dist

    from fhe_sorting_tpu_torch.parallel.limb_parallel import LimbParallelEvaluator
    from fhe_sorting_tpu_torch.parallel.mesh import init_world, make_mesh, make_mesh_2d
    from fhe_sorting_tpu_torch.utils import large_sort

    tmp = tempfile.mkdtemp(prefix="fhe_world_")
    init_world("nccl", 0, 1, os.path.join(tmp, "init"))
    try:
        mesh = make_mesh()
        # -- the sharded DirectSort
        t0 = time.time()
        ctx, keys, srt, info = large_sort.sharded_direct(n, mesh)
        _sync()
        setup_s = time.time() - t0
        print(f"# {info['what']}, ring 2^17: depth {info['depth']} (metered on the sharded "
              f"class), Lq={ctx.num_q}, K={ctx.num_sp}, logQP {info['logqp']:.1f} against "
              f"{large_sort.LOGQP_128}; reckoned before allocating: {info['reports'][0]}; setup "
              f"{setup_s:.1f}s ({len(keys.rot)} rotation keys + relin) ({smi})")
        x = np.random.default_rng(0).permutation(n) / n + 0.5 / n
        ct = keys.encrypt(x, slots=n)
        t0 = time.time()
        srt(ct)
        _sync()
        warm_s = time.time() - t0
        out, secs, counts = _counted(counters, lambda: srt(ct))
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = keys.decrypt(out, n)
        err = float(np.abs(got - np.sort(x)).max())
        print(f"# sharded DirectSort N={n}: warm-up {warm_s:.2f}s, sort {secs:.2f}s (the staged "
              f"N=1024 sort, `large_sort --path staged`, took 72.76 s on an H100 at 700 W), "
              f"output level {out.level}; max sort error {err:.3e} ({smi})")
        _check_memory(f"sharded DirectSort N={n}", info["reports"][0], peak, smi)
        if not np.all(np.isfinite(got)) or got.shape != (n,) or not err < 0.01:
            raise AssertionError(f"sharded DirectSort: sort error {err} >= 0.01")
        k2 = _require_k2_only("sharded DirectSort", counts)

        # -- limb parallelism on a (1 x 1) mesh, through the NCCL all-gathers
        lp = LimbParallelEvaluator(srt.ev, make_mesh_2d(1, 1))
        y = keys.encrypt(np.random.default_rng(7).uniform(-1, 1, RING // 2), seed=7)
        sh = lp.ingest(y)

        def limb_ops():
            return lp.gather(lp.rotate(lp.rescale(lp.mult(sh, sh)), 1))

        plain = srt.ev.rotate(srt.ev.rescale(srt.ev.mult(y, y)), 1)
        sharded, limb_s, counts = _counted(counters, limb_ops)
        if not torch.equal(sharded.data, plain.data):
            raise AssertionError("limb-parallel mult + rescale + rotate differs from the plain one")
        print(f"# limb-parallel mult + rescale + rotate on a (1 x 1) NCCL mesh, ring 2^17: "
              f"bit-equal to the plain evaluator, {limb_s:.3f}s ({smi})")
        k2 += _require_k2_only("limb-parallel", counts)
        del ctx, keys, srt, info, ct, out, lp, y, sh, sharded, plain
        _release()

        # -- the sharded MEHP24 triangle
        t0 = time.time()
        ctx, keys, srt, info = large_sort.sharded_mehp24(n_mehp, mesh)
        _sync()
        setup_s = time.time() - t0
        print(f"# {info['what']}, ring 2^17: depth {info['depth']}, Lq={ctx.num_q}, "
              f"K={ctx.num_sp}, logQP {info['logqp']:.1f}; reckoned before allocating: "
              f"{info['reports'][0]}; setup {setup_s:.1f}s ({smi})")
        x = np.random.default_rng(6).permutation(n_mehp) / n_mehp + 0.5 / n_mehp
        tile = large_sort.TILE
        parts = []
        for i in range(n_mehp // tile):
            pad = np.zeros(info["slots"])
            pad[:tile] = x[i * tile:(i + 1) * tile]
            parts.append(keys.encrypt(pad, slots=info["slots"]))
        out, secs, counts = _counted(counters, lambda: srt(parts))
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = np.concatenate([keys.decrypt(c, tile) for c in out])
        err = float(np.abs(got - np.sort(x)).max())
        print(f"# sharded MEHP24 N={n_mehp}: sort {secs:.2f}s (phase 12 above sorts N=512 on the "
              f"staged MEHP24, 8.18 s on an H100 at 700 W), output level {out[0].level}; max "
              f"sort error {err:.3e} ({smi})")
        _check_memory(f"sharded MEHP24 N={n_mehp}", info["reports"][0], peak, smi)
        if not np.all(np.isfinite(got)) or got.shape != (n_mehp,) or not err < 0.01:
            raise AssertionError(f"sharded MEHP24: sort error {err} >= 0.01")
        k2 += _require_k2_only("sharded MEHP24", counts)
        del ctx, keys, srt, info, parts, out
        _release()
        return k2
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _phase14_scan(ctx2, counters, smi):
    """ScanDirectSort eagerly and on graphs: N=128 at ring 2^17 on the per-op
    path's butterfly context (one batch), and N=64 at ring 2^12 (two
    batches: the body is replayed with its carry), each on its own keys.  The sort on graphs
    runs a warm-up (eager runs and captures, filling the plaintext memo),
    then the eager sort and a sort of replays run, each counted, so both
    find the memo warm; returns the replays' K2 launches, summed over both
    rings."""
    from fhe_sorting_tpu_torch.core.context import CkksParams, Context
    from fhe_sorting_tpu_torch.core.evaluator import Evaluator
    from fhe_sorting_tpu_torch.core.keys import Keys
    from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig
    from fhe_sorting_tpu_torch.parallel.direct_scan import ScanDirectSort, scan_rotation_indices
    from fhe_sorting_tpu_torch.utils import hbm_budget
    from fhe_sorting_tpu_torch.utils.depth_meter import measure_direct_sort_depth
    from fhe_sorting_tpu_torch.utils.params_registry import direct_sort_sign_cfg

    k2 = 0
    for n, ring in ((N, RING), (64, 1 << 12)):
        cfg = SignConfig(CompositeSignConfig(*direct_sort_sign_cfg(n)))
        if ring == RING:
            ctx = ctx2
        else:
            depth = measure_direct_sort_depth(n, ring, cfg)["mult_depth"]
            ctx = Context(CkksParams(ring_n=ring, mult_depth=depth, scale_bits=56, comp=2,
                                     base_limbs=4, ntt_impl="butterfly"))
        kset = Keys.generate(ctx, seed=0)
        kset.gen_rotation_keys(sorted(scan_rotation_indices(n, ring)))
        report = hbm_budget.check_phase(ctx, len(kset.rot), 4,
                                        work_cts=hbm_budget.WORK_CTS["direct_scan_graphs"],
                                        label=f"scan N={n}")
        ev = Evaluator(ctx, kset)
        held = torch.cuda.memory_allocated() / 2**30
        x = np.random.default_rng(8).permutation(n) / n + 0.5 / n
        ct = kset.encrypt(x)
        eager = ScanDirectSort(ev, n, cfg, graphs=False)
        srt = ScanDirectSort(ev, n, cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        srt(ct)
        _sync()
        warm_s = time.time() - t0
        warm_peak = torch.cuda.max_memory_allocated() / 2**30
        out_e, eager_s, counts_e = _counted(counters, lambda: eager(ct))
        out, secs, counts = _counted(counters, lambda: srt(ct))
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = kset.decrypt(out, n)
        err = float(np.abs(got - np.sort(x)).max())
        graphs = srt.graph_stats()
        print(f"# scan N={n}, ring 2^{ring.bit_length() - 1}: P={srt.P}, {srt.nb} batch(es); eager "
              f"{eager_s:.3f}s, warm-up on graphs {warm_s:.3f}s (captures "
              f"{sum(g[1] for g in graphs.values()):.2f}s), replayed {secs:.3f}s; dispatches "
              f"{ {k: g[0] for k, g in graphs.items()} }; max sort error {err:.3e}; peak "
              f"{warm_peak:.2f} GiB in the warm-up, {peak:.2f} GiB replaying, of which {held:.2f} "
              f"GiB were held before the sort ({smi})")
        _check_memory(f"scan N={n}", report, max(warm_peak, peak), smi)
        if not torch.equal(out.data, out_e.data):
            raise AssertionError(f"scan N={n}: the sort on graphs differs from the eager sort")
        if counts != counts_e:
            raise AssertionError(f"scan N={n}: launches on graphs {counts} != eager {counts_e}")
        if not np.all(np.isfinite(got)) or got.shape != (n,) or not err < 0.01:
            raise AssertionError(f"scan N={n}: sort error {err} >= 0.01")
        k2 += _require_k2_only(f"scan N={n} on graphs", counts)
        del eager, srt, ev, ct, out, out_e, kset, ctx
        _release()
    return k2


def _phase15_affine(ctx, keys, ct, vals, cfg, out_ref, gather_s, counters, smi):
    """The gather-free automorphism (`core/auto_affine.py`) on phase 5's K1
    context and keys: (a) the microbenchmark at [2, Lq, 2^17] and on one
    hoisted operand [3, Lq+K, 2^17], the affine path equal to the gather for
    rotations 1, -1, 64 and conjugation; (b) the staged N=128 sort on an
    evaluator built with FHE_AFFINE_AUTO=1, eagerly and on CUDA graphs, each
    output equal to phase 5's gather sort `out_ref` (seconds `gather_s`, by
    label: eager and on graphs); (c) the experiment
    ladder (DirectSort N=4, 8, three trials, ring 2048) and its aggregate;
    (d) the decrypt probe; (e) the rotation bench.  Returns the K1 launches
    of the affine sort on graphs and the K2 launches of (c)-(e)."""
    from fhe_sorting_tpu_torch.core.evaluator import Evaluator
    from fhe_sorting_tpu_torch.parallel.direct_staged import StagedDirectSort
    from fhe_sorting_tpu_torch.utils import (
        auto_microbench, experiments, hbm_budget, probe_direct, rotation_bench)

    # -- (a) the microbenchmark
    t0 = time.time()
    tables = ctx.auto_tables()
    _sync()
    print(f"# affine: tables of the {ctx.num_q + ctx.num_sp} primes {time.time() - t0:.2f}s, "
          f"{tables.nbytes() / 2**30:.3f} GiB ({hbm_budget.affine_table_bytes(ctx) / 2**30:.3f} "
          f"GiB reckoned)")
    for label, limbs, batch in (("a ciphertext", ctx.active_limbs(0), 2),
                                ("a hoisted operand", ctx.target_limbs(0), 3)):
        r = auto_microbench.bench(ctx, limbs, batch, reps=10)
        print(f"# affine microbench, {label}: {auto_microbench.describe(r)} ({smi})")
        print("# affine microbench JSON: " + json.dumps(r))
    print("# one affine automorphism of [2, Lq, 2^17] by kernel (torch.profiler):\n# "
          + auto_microbench.profile(ctx, ctx.active_limbs(0), 2).replace("\n", "\n# "))
    _release()

    # -- (b) the staged N=128 sort on the affine path, eagerly and on graphs
    prev = os.environ.get("FHE_AFFINE_AUTO")
    os.environ["FHE_AFFINE_AUTO"] = "1"
    try:
        ev = Evaluator(ctx, keys)
    finally:
        if prev is None:
            del os.environ["FHE_AFFINE_AUTO"]
        else:
            os.environ["FHE_AFFINE_AUTO"] = prev
    if not ev.use_affine:
        raise AssertionError("affine: FHE_AFFINE_AUTO=1 on a K1 context must turn the path on")
    autos = [0]
    apply_auto = ev._apply_auto

    def counted_auto(*a, **kw):
        autos[0] += 1
        return apply_auto(*a, **kw)

    ev._apply_auto = counted_auto
    k1_graphs = 0
    for (label, graphs), ref_s in zip((("affine sort eager", False), ("affine sort on graphs", None)),
                                      gather_s):
        report = hbm_budget.check_phase(
            ctx, len(keys.rot), 4, work_cts=hbm_budget.work_cts("direct_staged", graphs is None),
            affine=True, label=f"{label} N={N}")
        srt = StagedDirectSort(ev, N, cfg, graphs=graphs)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        srt(ct)
        _sync()
        warm_s = time.time() - t0
        warm_peak = torch.cuda.max_memory_allocated() / 2**30
        autos[0] = 0
        out, secs, (k1, k2) = _counted(counters, lambda: srt(ct))
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = keys.decrypt(out, N)
        err = float(np.abs(got - np.sort(vals)).max())
        per_sort = {}
        for (op, *_), v in srt.stage_stats().items():
            per_sort[op] = per_sort.get(op, 0) + v // srt.stages["D"].calls
        print(f"# {label} N={N} (K1 context, FHE_AFFINE_AUTO=1): warm-up {warm_s:.3f}s, sort "
              f"{secs:.3f}s against {ref_s:.3f}s by the gather (phase 5); K1 launches {k1}, K2 launches "
              f"{k2}; automorphisms a sort: {per_sort.get('rot', 0)} rotations (op_stats), "
              f"{per_sort.get('mult_pt', 0)} plaintext products, {autos[0]} affine automorphisms "
              f"run from Python in the timed sort (0 on graphs: replays); graphs "
              f"{srt.stages.graph_count()}, captured in {srt.stages.capture_seconds():.2f}s; peak "
              f"{warm_peak:.2f} GiB in the warm-up, {peak:.2f} GiB in the sort; max sort error "
              f"{err:.3e} ({smi})")
        _check_memory(label, report, max(peak, warm_peak), smi)
        if not torch.equal(out.data, out_ref.data):
            raise AssertionError(f"{label}: output planes differ from phase 5's gather sort")
        if k1 <= 0 or k2 != 0:
            raise AssertionError(f"{label}: the staged path must launch K1 and not K2")
        if not np.all(np.isfinite(got)) or not err < 0.01:
            raise AssertionError(f"{label}: sort error {err} >= 0.01")
        if graphs is None:
            k1_graphs = k1
        del srt, out
        _release()
    del ev, tables
    _release()

    # -- (c) the experiment ladder, (d) the probe, (e) the rotation bench
    tmp = tempfile.mkdtemp(prefix="fhe_ladder_")
    try:
        out_dir = os.path.join(tmp, "direct")
        rows, secs, counts = _counted(counters, lambda: experiments.main(
            ["--algo", "direct", "--sizes", "4", "8", "--trials", "3", "--out", out_dir]))
        total = experiments.aggregate(out_dir)
        k2 = _require_k2_only("ladder", counts)
        for row in total["results"]:
            print(f"# ladder row ({secs:.1f}s in all, ring 2048): {json.dumps(row)} ({smi})")
            if not 2.0 ** row["max_err_log2"] < 0.01:
                raise AssertionError(f"ladder N={row['N']}: max error 2^{row['max_err_log2']} >= 0.01")
        if [r["N"] for r in total["results"]] != [4, 8] or total["results"] != rows:
            raise AssertionError("ladder: the aggregate differs from the rows the run wrote")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res, secs, counts = _counted(counters, lambda: probe_direct.main(["--n", "16", "--ring", "4096"]))
    print(f"# probe DirectSort N=16, ring 2^12: rank error {res['rank_err']:.3e}, sort error "
          f"{res['sort_err']:.3e}, constructRank {res['t_rank_s']:.3f}s, rotationIndexCheckN "
          f"{res['t_idx_s']:.3f}s ({smi})")
    if not res["sort_err"] < 0.01:
        raise AssertionError(f"probe: sort error {res['sort_err']} >= 0.01")
    k2 += _require_k2_only("probe", counts)
    res, secs, counts = _counted(counters, lambda: rotation_bench.main(
        ["--ring", "4096", "--chains", "1", "5", "10"]))
    print(f"# rotation bench, ring 2^12: {json.dumps(res['results'])} ({smi})")
    k2 += _require_k2_only("rotation bench", counts)
    return k1_graphs, k2


def _phase16_entry_points(counters, smi):
    """The port's entry points for the system's own measurements, each run
    as a user runs it: (a) the flagship benchmark (`utils/bench.py`) at
    N=128 with one timed trial, as a subprocess through its orchestrator,
    its result line held to `bench.py`'s keys, an error below 0.01, the
    128-bit budget and a share of the speed of light in (0, 105)%, and K1
    launched in its timed sort (its worker's count); (b) the NTT
    microbenchmark (`utils/ntt_bench.py`) at its defaults, every transform,
    forward and inverse, bit-equal to the plain butterfly; (c) K1 held to its
    plain version on the bootstrap harness's chain, then the harness
    (`utils/run_bootstrap.py`) at its defaults, ring 2^14 under a sparse
    secret on K1, max error below 1e-2.  Returns the (K1, K2) launches of
    the bench's timed sort and of the refresh, and K1's largest difference
    from its plain version; the launches of the NTT bench and of the checks
    only time and compare the kernels, and are not counted."""
    from fhe_sorting_tpu_torch.core import fs_ntt, ntt_mxu
    from fhe_sorting_tpu_torch.utils import bench, ntt_bench, run_bootstrap

    # -- (a) the flagship benchmark, in its own worker process
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "fhe_sorting_tpu_torch.utils.bench", "--n",
                           str(N), "--trials", "1"], capture_output=True, text=True, env=env,
                          cwd=root)
    secs = time.time() - t0
    for line in proc.stderr.strip().splitlines()[-30:]:
        print(f"# bench stderr | {line}")
    if proc.returncode != 0:
        raise AssertionError(f"bench: exit code {proc.returncode}")
    line = proc.stdout.strip().splitlines()[-1]
    print(f"# bench line (N={N}, one timed trial, {secs:.1f}s in all): {line}")
    res = json.loads(line)
    keys = {"metric", "unit", "value", "vs_baseline", "max_error", "err_method", "phase_s",
            "phase_pct_of_sol", "logqp_bits", "logqp_128bit_budget", "security_128bit",
            "pct_of_sol", "sol_bound_s", "baseline_ref_s", "baseline_src"}
    if set(res) != keys:
        raise AssertionError(f"bench: keys {sorted(res)} are not bench.py's")
    if not (res["max_error"] < 0.01 and res["security_128bit"] is True
            and res["err_method"] == "decrypt" and res["value"] > 0
            and 0 < res["pct_of_sol"] < 105):
        raise AssertionError(f"bench: result out of bounds: {res}")
    k1_bench, k2_bench = map(int, bench.LAUNCH_LINE.search(proc.stderr).groups())
    print(f"# bench: K1 launches {k1_bench}, K2 launches {k2_bench} in the timed sort ({smi})")
    if k1_bench <= 0:
        raise AssertionError("bench: the timed sort did not launch K1")

    # -- (b) the NTT microbenchmark; its launches compare and time, uncounted
    saved = [mod.launches for mod in counters]
    buf = io.StringIO()
    t0 = time.time()
    _quiet(buf, lambda: ntt_bench.main([]))
    for line in buf.getvalue().strip().splitlines():
        print(f"# ntt_bench | {line}")
    exact = [line for line in buf.getvalue().splitlines() if line.startswith("bit-exact match")]
    if len(exact) != 6 or not all(line.endswith(": True") for line in exact):
        raise AssertionError(f"ntt_bench: {exact}")
    print(f"# ntt_bench at its defaults: {time.time() - t0:.1f}s")
    for mod, n in zip(counters, saved):
        mod.launches = n
    _release()

    # -- (c) the bootstrap harness at its defaults (ring 2^14, K1), after K1
    # against its plain version on that chain (n1 = n2 = 128): every prime,
    # and the key switch's extended set at the refresh's input level
    bctx = run_bootstrap.harness_context(run_bootstrap.parser().parse_args([]))
    ring, tabs = bctx.params.ring_n, bctx.tables
    if bctx.ntt_impl != "mxu":
        raise AssertionError(f"run_bootstrap: NTT {bctx.ntt_impl} at its defaults, not K1")
    gen = torch.Generator(device=bctx.device)
    gen.manual_seed(16)
    k1_err = 0
    for limbs, label in ((None, "every prime"), (bctx.target_limbs(8), "level 8 + special")):
        p = tabs.p if limbs is None else tabs.p[limbs]
        k1_err = max(k1_err, _check(
            "K1", lambda x, inv: fs_ntt.four_step(x, tabs, limbs, inv),
            lambda x, inv: ntt_mxu.ntt_plain(x, tabs, limbs, inv),
            _rand_residues(gen, (2, p.shape[0], *ntt_mxu.split_n(ring)), p),
            f"ring 2^{ring.bit_length() - 1}, B=2, L={p.shape[0]} ({label}; run_bootstrap's "
            f"chain, Lq={bctx.num_q}, K={bctx.num_sp})"))
    del bctx, tabs
    _release()
    tmp = tempfile.mkdtemp(prefix="fhe_boot_")
    try:
        buf = io.StringIO()
        out, secs, counts = _counted(counters, lambda: _quiet(buf, lambda: run_bootstrap.main(
            ["--out", os.path.join(tmp, "level_budgets.json")])))
        print(f"# run_bootstrap row: {buf.getvalue().strip()} ({smi})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    k1_boot, k2_boot = counts
    print(f"# run_bootstrap: K1 launches {k1_boot}, K2 launches {k2_boot}; {secs:.1f}s in all")
    if not out["max_err"] < 1e-2:
        raise AssertionError(f"run_bootstrap: max error {out['max_err']} >= 1e-2")
    if k1_boot <= 0:
        raise AssertionError("run_bootstrap: the refresh did not launch K1")
    return k1_bench + k1_boot, k2_bench + k2_boot, k1_err


def _quiet(buf, fn):
    """fn() with its standard output into `buf`."""
    with contextlib.redirect_stdout(buf):
        return fn()


def _roofline_line(ctx, srt, phase_s, smi):
    """The staged sort's share of the speed of light on this card, phase by
    phase: `roofline.phase_sol` over one sort's tallies
    (`StagedDirectSort.one_sort_stats`) against the phase seconds
    `_run_sort` measured."""
    from fhe_sorting_tpu_torch.utils import roofline

    for (phase, (sol, by_op, units)), secs in zip(
            roofline.phase_sol(ctx, srt.one_sort_stats()).items(), phase_s):
        print(f"# roofline, staged N={N} {phase} (K1 context): measured {secs:.3f}s, SoL "
              f"{sol * 1e3:.2f} ms on {roofline.H100.name} = {100 * sol / secs:.2f}% of SoL; "
              f"bound by {max(units, key=units.get)} "
              f"({', '.join(f'{u} {t * 1e3:.2f} ms' for u, t in units.items())}); by op: "
              f"{', '.join(f'{k} {t * 1e3:.2f} ms' for k, t in by_op.items())} ({smi})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from fhe_sorting_tpu_torch.core import bf_ntt, cuda_build, fs_ntt, ntt, ntt_mxu
    from fhe_sorting_tpu_torch.core import primes as primes_mod
    from fhe_sorting_tpu_torch.core.evaluator import Evaluator
    from fhe_sorting_tpu_torch.core.keys import Keys
    from fhe_sorting_tpu_torch.models.direct_sort import DirectSort, rotation_indices_direct_sort
    from fhe_sorting_tpu_torch.ops.sign import SignFunc
    from fhe_sorting_tpu_torch.parallel.direct_staged import (
        StagedDirectSort, scan_rotation_indices)
    from fhe_sorting_tpu_torch.utils import hbm_budget
    from fhe_sorting_tpu_torch.utils.depth_meter import measure_direct_sort_depth
    from fhe_sorting_tpu_torch.utils.profile_sort import sort_context

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # -- phase 2: build K1 and K2 ----------------------------------------------
    t0 = time.time()
    cuda_build.build(["fs_ntt", "bf_ntt"])
    fs_ntt.load()
    bf_ntt.load()
    print(f"# K1 + K2 build (in parallel) + load: {time.time() - t0:.2f}s")
    for name, (secs, report) in cuda_build.reports.items():
        print(f"# nvcc {name}.cu: {secs:.2f}s")
        print("# " + report.strip().replace("\n", "\n# "))

    # -- phase 3: K1 against its plain version ---------------------------------
    # the bench's chain (`profile_sort.sort_context`): the metered depth,
    # which the per-op sort needs too
    t0 = time.time()
    ctx, cfg, depth = sort_context(N, "staged")
    ctx_s = time.time() - t0
    assert depth == measure_direct_sort_depth(N, RING, cfg, staged=False)["mult_depth"]
    assert ctx.device == dev and ctx.ntt_impl == "mxu", (ctx.device, ctx.ntt_impl)
    Lq, Ltot = ctx.num_q, ctx.num_q + ctx.num_sp
    print(f"# four-step context: ring 2^17, depth {depth}, Lq={Lq}, K={ctx.num_sp}, {ctx_s:.1f}s; "
          f"K1's digit planes and packed twiddles for the {Ltot} primes: "
          f"{ctx.tables.kern.nbytes() / 2**30:.3f} GiB beside the int64 tables")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fs = ctx.tables
    n1, n2 = ntt_mxu.split_n(RING)
    few = torch.tensor([0, 1, Lq - 1, Ltot - 1], dtype=torch.int64, device=dev)
    active = ctx.active_limbs(0)

    def k1(limbs, t=fs):
        return (lambda x, inv: fs_ntt.four_step(x, t, limbs, inv),
                lambda x, inv: ntt_mxu.ntt_plain(x, t, limbs, inv))

    k1_err = _check("K1", *k1(few), _rand_residues(gen, (2, 4, n1, n2), fs.p[few]),
                    "ring 2^17, B=2, 4 limbs (active and special)")
    x4 = _rand_residues(gen, (2, Lq, n1, n2), fs.p[active])
    k1_err = max(k1_err, _check("K1", *k1(active), x4,
                                f"ring 2^17, B=2, L={Lq} (a full ciphertext)"))
    small_primes = primes_mod.ntt_primes(4096, 28, 3)
    small = ntt_mxu.build_fs_tables(small_primes, 4096, dev)
    k1_err = max(k1_err, _check("K1", *k1(None, small),
                                _rand_residues(gen, (2, 3, 64, 64), small.p),
                                "ring 2^12, B=2, L=3"))
    k1_ms = _time_ms(lambda: fs_ntt.four_step(x4, fs, active, False), 10)
    k1_plain_ms = _time_ms(lambda: ntt_mxu.ntt_plain(x4, fs, active, False), 3)
    k1_inv_ms = _time_ms(lambda: fs_ntt.four_step(x4, fs, active, True), 10)
    special = torch.arange(Lq, Ltot, dtype=torch.int64, device=dev)
    xs = _rand_residues(gen, (1, ctx.num_sp, n1, n2), fs.p[special])
    k1_small_ms = [_time_ms(lambda: fs_ntt.four_step(xs, fs, special, inv), 20)
                   for inv in (False, True)]

    # -- phase 4: K2 against its plain version and against K1 ------------------
    t0 = time.time()
    ctx2 = sort_context(N, "staged", "butterfly", depth=depth)[0]
    ctx2_s = time.time() - t0
    assert ctx2.ntt_impl == "butterfly" and ctx2.all_primes == ctx.all_primes
    print(f"# butterfly context: same chain, {ctx2_s:.1f}s")
    bf = ctx2.tables

    def k2(limbs, t=bf):
        return (lambda x, inv: bf_ntt.butterfly(x, t, limbs, inv),
                lambda x, inv: ntt.butterfly_plain(x, t, limbs, inv))

    k2_err = _check("K2", *k2(few), _rand_residues(gen, (2, 4, RING), bf.p[few]),
                    "ring 2^17, B=2, 4 limbs (active and special)")
    x3 = x4.reshape(2, Lq, RING)
    k2_err = max(k2_err, _check("K2", *k2(active), x3,
                                f"ring 2^17, B=2, L={Lq} (a full ciphertext)"))
    for ring, bits in ((1 << 12, 28), (1 << 10, 28)):
        t_small = ntt.build_device_tables(primes_mod.ntt_primes(ring, bits, 3), ring, dev)
        k2_err = max(k2_err, _check(
            "K2", *k2(None, t_small), _rand_residues(gen, (2, 3, ring), t_small.p),
            f"ring 2^{ring.bit_length() - 1}, B=2, L=3 (one block per plane)"))
    fwd2 = bf_ntt.butterfly(x3, bf, active, False)
    fwd1 = fs_ntt.four_step(x4, fs, active, False).reshape(2, Lq, RING)
    back1 = fs_ntt.four_step(fwd2.reshape(2, Lq, n1, n2), fs, active, True).reshape(2, Lq, RING)
    if not (torch.equal(fwd1, fwd2) and torch.equal(back1, x3)):
        raise AssertionError("K2 and K1 disagree on the same [2, Lq, 2^17] planes")
    print(f"# K2 == K1 on [2, {Lq}, 2^17]: same bit-reversed evaluation order, "
          f"and K1's inverse undoes K2's forward")
    del fwd1, fwd2, back1

    k2_ms = _time_ms(lambda: bf_ntt.butterfly(x3, bf, active, False), 20)
    k2_inv_ms = _time_ms(lambda: bf_ntt.butterfly(x3, bf, active, True), 20)
    k2_plain_ms = _time_ms(lambda: ntt.butterfly_plain(x3, bf, active, False), 2)
    k2_plain_inv_ms = _time_ms(lambda: ntt.butterfly_plain(x3, bf, active, True), 2)
    xs = xs.reshape(1, ctx.num_sp, RING)
    k2_small_ms = [_time_ms(lambda: bf_ntt.butterfly(xs, bf, special, inv), 20)
                   for inv in (False, True)]
    logn = RING.bit_length() - 1
    c_log = bf_ntt.cluster_log(logn)
    print(f"# K2 at ring 2^17: one launch per transform, clusters of {1 << c_log} blocks; "
          f"cudaOccupancyMaxActiveClusters {bf_ntt.max_active_clusters(logn, c_log)}")
    shape = f"[2, {Lq}, 2^17]"
    print(f"# K1 forward NTT {shape}: kernel {k1_ms:.3f} ms, plain four-step "
          f"{k1_plain_ms:.3f} ms; inverse kernel {k1_inv_ms:.3f} ms ({smi})")
    print(f"# K2 forward NTT {shape}: kernel {k2_ms:.3f} ms, plain butterfly "
          f"{k2_plain_ms:.3f} ms ({smi})")
    print(f"# K2 inverse NTT {shape}: kernel {k2_inv_ms:.3f} ms, plain butterfly "
          f"{k2_plain_inv_ms:.3f} ms ({smi})")

    small_shape = f"[1, {ctx.num_sp}, 2^17] on the special limbs"
    print(f"# K1 NTT {small_shape}: forward {k1_small_ms[0]:.3f} ms, inverse {k1_small_ms[1]:.3f} ms ({smi})")
    print(f"# K2 NTT {small_shape}: forward {k2_small_ms[0]:.3f} ms, inverse {k2_small_ms[1]:.3f} ms ({smi})")

    # the least time the card could take for one forward transform of x: K1
    # and K2 compute the same function, so the bound is one
    bound, k2_form_ms = _ntt_bound(2 * Lq, Lq, RING)
    k1_form_ms = _ops_ms(2.0 * 2 * Lq * RING * (n1 + n2))
    print(f"# bound for one forward transform of {shape}, K1 and K2 alike: {bound[0]:.3f} ms "
          f"by {bound[1]}; the arithmetic of each form at the CUDA cores' rate: "
          f"K1 {k1_form_ms:.3f} ms, K2 {k2_form_ms:.3f} ms ({smi})")
    del x3, x4, xs, small
    torch.cuda.empty_cache()

    vals = np.random.default_rng(0).permutation(N) / N + 0.5 / N

    # -- phase 5: the staged path (four-step context, K1), eager and on graphs --
    t0 = time.time()
    scan = sorted(scan_rotation_indices(N, RING))
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys(scan)
    ev = Evaluator(ctx, keys)
    _sync()
    print(f"# staged: keys ({len(keys.rot)} rotation + relin) {time.time() - t0:.2f}s")
    ct = keys.encrypt(vals)
    staged = {}
    for label, graphs in (("staged eager", False), ("staged on graphs", None)):
        report = hbm_budget.check_phase(
            ctx, len(scan), 4, work_cts=hbm_budget.work_cts("direct_staged", graphs is None),
            label=f"{label} N={N}")
        srt = StagedDirectSort(ev, N, cfg, graphs=graphs)
        staged[label] = (srt, *_run_sort(label, keys, ct, vals, srt, srt.construct_rank,
                                         srt.index_check, (fs_ntt, bf_ntt), smi, report))
        k1_count, k2_stray = staged[label][1]
        print(f"# {label}: K1 launches {k1_count}, K2 launches {k2_stray}; stage calls: "
              f"{ {name: st.calls for name, st in srt.stages.items()} }")
        if k1_count <= 0 or k2_stray != 0:
            raise AssertionError(f"{label}: the staged path must launch K1 and not K2")
        del srt
        _release()
    (_, (k1_eager, _), eager_s, _, out_e, _), (srt, (k1_launches, _), staged_s, phase_s, out_g,
                                               (warm_s, warm_peak, peak)) = staged.values()
    if not torch.equal(out_e.data, out_g.data):
        raise AssertionError("staged: the sort on graphs differs from the eager sort")
    if k1_launches != k1_eager:
        raise AssertionError(f"staged: K1 launches on graphs {k1_launches} != eager {k1_eager}")
    print(f"# staged N={N} on K1: eager {eager_s:.3f}s, on graphs {staged_s:.3f}s (output planes "
          f"equal); {srt.stages.graph_count()} graphs, captured in {srt.stages.capture_seconds():.2f}s "
          f"of a {warm_s:.2f}s warm-up sort; K1 launches a sort {k1_launches} (replay tallies); "
          f"peak {warm_peak:.2f} GiB in the warm-up, {peak:.2f} GiB replaying ({smi})")
    _roofline_line(ctx, srt, phase_s, smi)
    del staged, srt, ev, out_e
    _release()

    # -- phase 15: the gather-free automorphism on phase 5's context and keys
    k1_affine, k2_phase15 = _phase15_affine(ctx, keys, ct, vals, cfg, out_g, (eager_s, staged_s),
                                            (fs_ntt, bf_ntt), smi)
    del keys, ctx, fs, k1, ct, out_g
    _release()

    # -- phase 6: the per-op path (butterfly context, K2) ----------------------
    t0 = time.time()
    steps = sorted(rotation_indices_direct_sort(N, RING))
    report = hbm_budget.check_phase(ctx2, len(steps), 4, work_cts=hbm_budget.WORK_CTS["direct_per_op"],
                                    label=f"per-op N={N}")
    keys = Keys.generate(ctx2, seed=0)
    keys.gen_rotation_keys(steps)
    ev = Evaluator(ctx2, keys)
    srt = DirectSort(ev, N)
    _sync()
    print(f"# per-op: keys ({len(keys.rot)} rotation + relin) {time.time() - t0:.2f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    (k1_stray, k2_launches), per_op_s, *_ = _run_sort(
        "per-op", keys, keys.encrypt(vals), vals,
        lambda ct: srt.sort(ct, SignFunc.CompositeSign, cfg),
        lambda ct: srt.construct_rank(ct, SignFunc.CompositeSign, cfg),
        srt.rotation_index_check_n, (fs_ntt, bf_ntt), smi, report)
    print(f"# per-op: K2 launches {k2_launches}, K1 launches {k1_stray}; "
          f"over the three sorts: {srt.rot.stats}")
    if k2_launches <= 0 or k1_stray != 0:
        raise AssertionError("the per-op butterfly path must launch K2 and not K1")
    print(f"# sorts side by side: staged on K1 {staged_s:.3f}s on graphs, {eager_s:.3f}s "
          f"eager; per-op on K2 {per_op_s:.3f}s ({smi})")
    del srt, ev

    # -- phases 7-14: the serving path, the scan sorts, what stands behind the
    # server, the k-way network, the staged N>256 regimes, the sharded sorts ---
    counters = (fs_ntt, bf_ntt)
    by_phase = {"per-op sort": k2_launches}
    by_phase["serve"] = _phase7_serve(ctx2, keys, counters, smi)
    del keys
    _release()
    by_phase["scan sorts"] = _phase14_scan(ctx2, counters, smi)
    by_phase["ladder, probe, rotation bench"] = k2_phase15
    del ctx2, bf, k2
    _release()
    for name, phase in (("bootstrap", _phase8_bootstrap), ("bitonic", _phase9_bitonic),
                        ("mehp24", _phase10_mehp24), ("characterizer", _characterizer_line),
                        ("k-way", _phase11_kway), ("staged N>256 regimes", _phase12_staged_large),
                        ("sharded sorts", _phase13_sharded)):
        by_phase[name] = phase(counters, smi)
        _release()
    # -- phase 16: the entry points of the system's own measurements --------
    k1_entry, by_phase["bench, run_bootstrap"], k1_err16 = _phase16_entry_points(counters, smi)
    k1_err = max(k1_err, k1_err16)
    _release()
    k2_launches = sum(by_phase.values())
    print(f"# K2 launches by phase: {by_phase}; K1 launches: staged sort {k1_launches} by the "
          f"gather, {k1_affine} on the affine path (each a sort on graphs), {k1_entry} in phase "
          f"16 (the bench's timed sort and the bootstrap harness's refresh)")
    k1_launches += k1_affine + k1_entry

    print(json.dumps({"kernels": [
        {"name": "fs_ntt (four-step NTT, K1)", "route": "cuda",
         "source": "fhe_sorting_tpu_torch/csrc/fs_ntt.cu",
         "replaces": "fhe_sorting_tpu/core/pallas_fs_ntt.py:97",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": bound[0], "bound_by": bound[1], "form_ops_ms": k1_form_ms,
         "library_ms": None},
        {"name": "bf_ntt (butterfly NTT, K2)", "route": "cuda",
         "source": "fhe_sorting_tpu_torch/csrc/bf_ntt.cu",
         "replaces": "fhe_sorting_tpu/core/pallas_ntt.py:66",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": bound[0], "bound_by": bound[1], "form_ops_ms": k2_form_ms,
         "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
