"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (each failure raises, and the script exits non-zero):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels K1 (four-step NTT on the s8 tensor cores), K2
     (butterfly NTT in one pass through a thread-block cluster), K3 (the
     exact division by a dropped modulus) and K4 (the key switch's base
     extension) from `fhe_sorting_tpu_torch/csrc`, one nvcc each, started
     together;
  3. hold K1 against its plain PyTorch version on the card, bit for bit:
     ring 2^17 (n1=256, n2=512) on limbs of the N=128 chain and on a whole
     ciphertext, and ring 2^12; time both at the ring-2^17 ciphertext shape.
     The N=128 chain's context names the four-step NTT (`ntt="mxu"`), since
     the default ("auto") is the butterfly on the card: phases 5 and 15 run
     K1 on it;
  4. require the default NTT of the same chain on the card to be the
     butterfly (K2), and hold K2 against its plain version the same way
     (ring 2^17 on four limbs and on a whole ciphertext, ring 2^12, ring
     2^10) and against K1 on the same planes; time K2, K1 and the plain
     butterfly, forward and inverse, and both kernels at one small
     transform of the sort, [1, K, 2^17] on the special limbs (ModDown's
     inverse NTT); print how many clusters (planes) of K2 the card holds at
     once;
  5. drive the staged path on K1: Context(ring 2^17, depth from the depth
     meter, four-step NTT) -> Keys -> Evaluator -> StagedDirectSort at
     N=128, eagerly (`graphs=False`) and on CUDA graphs (the default: each stage one
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
  6. drive the per-op path the same way on phase 4's default context (K2):
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
     the staged hybrid DirectSort (depth 48, its 16 keys held together) and
     the staged MEHP24 triangle (depth 46), on CUDA graphs, each sorting one
     input twice: max error < 0.01, and the second sort only replays and
     gives the first's output;
 13. the multi-device sorts on a one-rank NCCL world (`file://` store in a
     temporary directory): ShardedDirectSort at N=1024 (depth metered on the
     sharded class, 20 rotation and 16 batch-offset keys) and ShardedMehp24
     at N=512 over two 256 x 256 parts on phase 12's MEHP24 chain, each
     eagerly and on CUDA graphs (each rank's stages captured, the
     all-reduces between them), a warm-up and a counted sort each way:
     output planes equal, K2 launches equal, max error < 0.01; between them
     a limb-parallel mult + rescale + rotate on a (1 x 1) mesh, eagerly and
     as a captured stage with its NCCL all-gather and broadcasts inside,
     replayed on a new input, bit-equal to the plain evaluator;
 17. (after phase 13) limb parallelism that splits the work: the sharded
     DirectSort N=128 on phase 5's chain (ring 2^17, comp=2, depth 32,
     Lq 68, K 23, dnum 3, butterfly NTT) on a (1 x 2) mesh of two gloo
     processes that share this card (NCCL refuses two ranks on one GPU),
     eagerly, and the same sort on a (1 x 1) mesh, each rank making its rows
     of one key set from seed 0 and encrypting one input from seed 1
     (`utils.multichip.run_limb_sort`): gathered output planes equal to
     the one rank's, max error < 0.01, K2 launched on each rank and K1 not,
     each rank's key bytes and the limb planes its key switches and
     rescales transform at most 0.55 of the one rank's; prints each rank's
     sort seconds, the bytes gathered and broadcast a sort, the plaintext
     encodes' planes apart, and each rank's peak beside its reckoning.
 16. (last) the entry points of the system's own measurements, each as a
     user runs it: `utils/ntt_bench.py` at its defaults ([2, 40, 2^16]: K2, the
     plain four-step and K1 bit-equal to the plain butterfly, then a
     rotation and a multiplication on its default NTT, K2); K1 against its
     plain version on `utils/run_bootstrap.py`'s chain with the four-step
     NTT named; `utils/run_bootstrap.py` at its defaults (ring 2^14, sparse
     secret, level budget 3, on the default NTT, K2), max error < 1e-2; K3
     against its plain versions, bit for bit, on the top of the
     `direct_n128` chain (ring 2^17, Lq 68: the first rescale's lift and
     division [2, 67, 2^17], ModDown's division [2, 68, 2^17]), timed beside
     its byte bound and beside the plain PyTorch chain it replaced; K4
     against its plain version, bit for bit, at the top ModUp and ModDown of
     the `mehp24_n512` chain (Lq 96, four digits of 24, K 24) and the top
     ModUp of `direct_n128`'s (a short last digit), on a strided view, timed
     the same way.
Every counted run of a main path (each a sort, a refresh or a run of
rotations, so each rescales and switches keys) reads the kernels' launch
counter (`core/cuda_build.py`, `{"k1": n, ...}`), set to 0 just before and
read just after (in phase 17 by each rank's process), and must launch its
context's NTT kernel and not the other (K2 on the butterfly contexts of
phases 6-14 and 17 and in 16's refresh, K1 on phases 5 and 15(b)), K3 and
K4, as often on graphs as eagerly where it runs both ways; the kernels' JSON gives
each kernel the sum of those runs' launches.  Every phase from 5 on
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

from fhe_sorting_tpu_torch.core import cuda_build

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


def _run_sort(label, keys, ct, vals, sort, phase1, phase2, smi, report):
    """A warm-up sort of `ct`, then a timed one, both through the entry point
    `sort`; the launch counter is set to 0 just before the timed sort and
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
    out, total, counts = _counted(lambda: sort(ct))
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


def _check_memory(label, report, peak_gib, smi, outside_gib=0.0):
    """Print a phase's measured peak beside what `check_phase` reckoned, and
    fail where it exceeds the budget the reckoning was made against, or
    where the peak less `outside_gib` (allocated before the phase and not
    its own) exceeds the reckoning."""
    from fhe_sorting_tpu_torch.utils import hbm_budget

    card = (f", {report['used_gib']} GiB for the {report['limb_ranks']} ranks on the card"
            if report["limb_ranks"] > 1 else "")
    print(f"# {label}: peak device memory {peak_gib:.2f} GiB measured, {report['rank_gib']} GiB "
          f"reckoned ({report['n_rot_keys']} rotation keys + relin, {report['n_cts']} + "
          f"{report['work_cts']} ciphertexts{card}), budget {report['budget_gib']} GiB ({smi})")
    hbm_budget.check_peak(report, peak_gib, outside_gib)


def _release():
    """Return the device memory of everything no longer referenced."""
    gc.collect()
    torch.cuda.empty_cache()


# the launches of each counted run of a main path, by the run's label
RUNS = {}


def _counted(fn):
    """fn() with the launch counter set to 0 just before and read just after
    (synchronised); returns (result, seconds, {kernel: launches})."""
    cuda_build.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    _sync()
    secs = time.time() - t0
    return out, secs, cuda_build.counts()


def _require(label, counts, ntt="k2"):
    """Record the launches `counts` of the counted run `label`, which must
    have launched the NTT kernel `ntt` of its context and not the other one
    (K2 on a butterfly context, K1 on a four-step one), and K3 and K4."""
    other = "k1" if ntt == "k2" else "k2"
    print(f"# {label}: launches {counts}")
    if counts[ntt] <= 0 or counts[other] != 0:
        raise AssertionError(f"{label}: must launch {ntt.upper()} and not {other.upper()}: "
                             f"{counts}")
    for key in ("k3", "k4"):
        if counts[key] <= 0:
            raise AssertionError(f"{label}: {key.upper()} was not launched")
    RUNS[label] = counts


def _same(label, got, want, how):
    if got != want:
        raise AssertionError(f"{label}: launches {how} {got} != {want}")


def _phase7_serve(ctx2, keys, smi):
    """Serve the tie-free vector of phases 5 and 6 from files through the
    server's entry point, and hold the decrypted output to max error < 0.01."""
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
            _, total_s, counts = _counted(lambda: sort_server.main([
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
        _require("serve", counts)
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


def _phase8_bootstrap(smi):
    """Two refreshes of 2^16 values in [0, 1].  The first, on an empty
    plaintext memo, is the bootstrap's time: it encodes every diagonal on the
    host, as every refresh does under the evaluator's default memo, which holds
    a fraction of one refresh's plaintexts.  The second shows what a memo
    that holds them all (24 GiB here) saves.  The uniform-ternary-secret
    shape; the second refresh must meet max error < 1e-2."""
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
    out, boot_s, counts = _counted(lambda: bs.bootstrap(ct_low))
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
    _require("bootstrap", counts)


def _phase9_bitonic(smi, n=8):
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
        lambda: srt.sort(keys.encrypt(x, slots=n), SignFunc.CompositeSign, cfg))
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
    _require("bitonic", counts)


def _phase10_mehp24(smi, n=64):
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
        lambda: srt.sort(keys.encrypt(padded, slots=n * n), SignFunc.CompositeSign, cfg))
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
    _require("mehp24", counts)


def _characterizer_line(smi):
    """The sign characterizer's sweep of CompositeSign(3,3,2) at ring 2^12 on
    a butterfly context (keys from seed 0, as the characterizer makes)."""
    from fhe_sorting_tpu_torch.core.context import CkksParams, Context
    from fhe_sorting_tpu_torch.core.keys import Keys
    from fhe_sorting_tpu_torch.utils.sign_characterizer import characterize

    ctx = Context(CkksParams(ring_n=1 << 12, mult_depth=(3 + 2) * 3 + 4, ntt_impl="butterfly"))
    keys = Keys.generate(ctx, seed=0)
    m, secs, counts = _counted(lambda: characterize(3, 3, 2, keys=keys))
    print(f"# sign characterizer, ring 2^12: {json.dumps(m)}; sweep {secs:.2f}s ({smi})")
    if m["working_precision"] is None:
        raise AssertionError("characterizer: no input magnitude met the threshold")
    _require("characterizer", counts)


def _phase11_kway(smi, n=16):
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
    out, secs, counts = _counted(lambda: run.sorter.sort(ct, SignFunc.CompositeSign, run.cfg))
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
    _require("k-way", counts)

    # one five-sorter stage: k=5, N=5 in 8 slots, on the chain's depth alone
    x5 = np.array([0.9, 0.1, 0.5, 0.7, 0.3])
    pad = np.zeros(8)
    pad[:5] = x5
    ct5 = run.keys.encrypt(pad, slots=8)
    srt5 = KWaySorter(run.ev, 5, 1)
    out5, secs5, counts5 = _counted(lambda: srt5.sort(
        ct5, SignFunc.CompositeSign, SignConfig(CompositeSignConfig(3, 3, 2))))
    got5 = run.keys.decrypt(out5, 5)
    err5 = float(np.abs(got5 - np.sort(x5)).max())
    print(f"# k-way five-sorter stage (k=5, N=5): {secs5:.2f}s, output level {out5.level}; max "
          f"sort error {err5:.3e} ({smi})")
    if not np.all(np.isfinite(got5)) or not err5 < 0.01:
        raise AssertionError(f"k-way five-sorter: sort error {err5} >= 0.01")
    _require("k-way five-sorter", counts5)


def _phase12_staged_large(smi, n=512):
    """The staged hybrid DirectSort and the staged MEHP24 triangle over two
    tiles, as `large_sort.staged_hybrid` and `staged_mehp24` configure them,
    each sorting the same input twice from keys made once: the second sort
    replays every stage's graph and captures none, leaves the key set as it
    was, and gives the first's output bit for bit.  The first also encodes
    the plaintexts its stages' memo keeps, so it transforms more planes."""
    from fhe_sorting_tpu_torch.core import trace
    from fhe_sorting_tpu_torch.utils import large_sort

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
        rot = dict(keys.rot)
        runs, peak = [], 0.0
        for _ in range(2):
            with trace.recording():
                out, secs, counts = _counted(lambda: sort(ct))
            peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
            spans = trace.spans()
            runs.append((out, secs, counts, [s for s in spans if "kind" in s.counts],
                         {s.name: (s.device[1] - s.device[0]) / 1e9 for s in spans
                          if s.parent is None and "kind" not in s.counts and s.device}))
        (out0, secs0, counts0, disp0, _), (out, secs, counts, disp, phases) = runs
        got = keys.decrypt(out, n)
        err = float(np.abs(got - np.sort(x)).max())
        kinds = {k: sum(d.counts["kind"] == k for d in disp) for k in ("capture", "replay")}
        planes = [sum(d.counts["planes"] for d in ds) for ds in (disp0, disp)]
        print(f"# {info['what']}, ring 2^17: depth {info['depth']}, Lq={ctx.num_q}, "
              f"K={ctx.num_sp}, logQP {info['logqp']:.1f}; setup {setup_s:.1f}s; first sort "
              f"{secs0:.2f}s, second {secs:.2f}s ("
              + ", ".join(f"{k} {v:.2f}s" for k, v in phases.items())
              + f" on the device), {len(disp)} dispatches {kinds}, NTT planes {planes[1]} (first "
              f"{planes[0]}), launches {counts} (first {counts0}), output level "
              f"{out.level}; max sort error {err:.3e} ({smi})")
        _check_memory(label, max(info["reports"], key=lambda r: r["used_gib"]), peak, smi)
        if not np.all(np.isfinite(got)) or not err < 0.01:
            raise AssertionError(f"{label}: sort error {err} >= 0.01")
        if kinds["replay"] != len(disp) or len(disp) != len(disp0):
            raise AssertionError(f"{label}: the second sort did not only replay: {kinds}")
        if not torch.equal(out.data, out0.data):
            raise AssertionError(f"{label}: the second sort's output differs from the first's")
        if keys.rot.keys() != rot.keys() or any(keys.rot[g] is not k for g, k in rot.items()):
            raise AssertionError(f"{label}: the sorts changed the key set")
        _require(label, counts)
        del ctx, keys, sort, info, ct, out, out0, runs, rot
        _release()


def _phase13_sharded(smi, n=1024, n_mehp=512):
    """The multi-device sorts on a one-rank NCCL world on this card, each
    eagerly and on CUDA graphs (its stages captured, the all-reduces
    between them) from the same keys and input: the sharded DirectSort at
    N=1024 and the sharded MEHP24 triangle at N=512, each way a warm-up sort
    and a counted one, the counted outputs bit-equal, each against the
    budget its memory was reckoned with; and a limb-parallel mult + rescale
    + rotate on a (1 x 1) mesh, eagerly and as a captured stage with its
    collectives (the key switch's all-gathers, the rescale's broadcasts)
    inside, bit-equal to the plain evaluator."""
    from fhe_sorting_tpu_torch.utils import large_sort

    return large_sort.one_rank_world(
        lambda mesh: _sharded_sorts(mesh, smi, n, n_mehp))


def _both_ways(label, make, run, smi, reports):
    """`run(srt)` of the sort `make(graphs)` eagerly (`graphs=False`) and on
    graphs: a warm-up, then a sort counted with `_counted`, each way; every
    peak held to that way's reckoning (`reports[graphs]`).  Returns the
    counted outputs and the sort on graphs.  The launches must agree both
    ways."""
    outs, launched = {}, {}
    for graphs in (False, True):
        way = "on graphs" if graphs else "eager"
        srt = make(None if graphs else False)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        run(srt)
        _sync()
        warm_s = time.time() - t0
        warm_peak = torch.cuda.max_memory_allocated() / 2**30
        outs[graphs], secs, counts = _counted(lambda: run(srt))
        peak = torch.cuda.max_memory_allocated() / 2**30
        st = srt.stages
        print(f"# {label} {way}: warm-up {warm_s:.2f}s, sort {secs:.2f}s; {len(st)} stages, "
              f"{st.graph_count()} graphs held, capture {st.capture_seconds():.2f}s of the "
              f"warm-up, {sum(g.calls for g in st.values())} dispatches over both sorts; peak "
              f"{warm_peak:.2f} GiB in the warm-up, {peak:.2f} GiB in the sort ({smi})")
        _check_memory(f"{label} {way}", reports[graphs], max(warm_peak, peak), smi)
        _require(f"{label} {way}", counts)
        launched[graphs] = counts
    _same(label, launched[True], launched[False], "on graphs against eager")
    return outs, srt


def _sharded_sorts(mesh, smi, n, n_mehp):
    from fhe_sorting_tpu_torch.parallel.direct_sharded import ShardedDirectSort
    from fhe_sorting_tpu_torch.parallel.limb_parallel import LimbParallelEvaluator
    from fhe_sorting_tpu_torch.parallel.mehp24_sharded import ShardedMehp24
    from fhe_sorting_tpu_torch.parallel.mesh import make_mesh_2d
    from fhe_sorting_tpu_torch.parallel.whole_graph import StageTable
    from fhe_sorting_tpu_torch.utils import hbm_budget, large_sort

    def reports(ctx, report, path):
        """{graphs: the reckoning}: the builder's on graphs, and the same
        keys and long-lived ciphertexts with the eager working set."""
        return {True: report, False: hbm_budget.check_phase(
            ctx, report["n_rot_keys"], report["n_cts"], work_cts=hbm_budget.WORK_CTS[path],
            label=f"{report['label']} eager")}

    # -- the sharded DirectSort
    t0 = time.time()
    ctx, keys, srt, info = large_sort.sharded_direct(n, mesh)
    _sync()
    setup_s = time.time() - t0
    reckoned = reports(ctx, info["reports"][0], "direct_sharded")
    print(f"# {info['what']}, ring 2^17: depth {info['depth']} (metered on the sharded "
          f"class), Lq={ctx.num_q}, K={ctx.num_sp}, logQP {info['logqp']:.1f} against "
          f"{large_sort.LOGQP_128}; reckoned before allocating: {reckoned[True]}; setup "
          f"{setup_s:.1f}s ({len(keys.rot)} rotation keys + relin) ({smi})")
    x = np.random.default_rng(0).permutation(n) / n + 0.5 / n
    ct = keys.encrypt(x, slots=n)
    outs, srt = _both_ways(
        f"sharded DirectSort N={n}",
        lambda graphs: srt if graphs is None else ShardedDirectSort(srt.ev, n, srt.cfg,
                                                                    mesh=mesh, graphs=False),
        lambda s: s(ct), smi, reckoned)
    if not torch.equal(outs[True].data, outs[False].data):
        raise AssertionError("sharded DirectSort: the sort on graphs differs from the eager sort")
    got = keys.decrypt(outs[True], n)
    err = float(np.abs(got - np.sort(x)).max())
    print(f"# sharded DirectSort N={n}: output planes equal eager and on graphs, output level "
          f"{outs[True].level}; max sort error {err:.3e} (the staged N=1024 sort on K2, "
          f"`large_sort --path staged`, took 63.60 s on graphs and 67.04 s eagerly on an H100 at "
          f"700 W) ({smi})")
    if not np.all(np.isfinite(got)) or got.shape != (n,) or not err < 0.01:
        raise AssertionError(f"sharded DirectSort: sort error {err} >= 0.01")

    # -- limb parallelism on a (1 x 1) mesh, through the NCCL all-gathers and
    # broadcasts of the distributed key switch and rescale: eagerly, then as
    # one stage on graphs, the collectives captured with it; its second call,
    # a replay, on a new input shows the replay runs them
    ev = srt.ev
    lp = LimbParallelEvaluator(ev, make_mesh_2d(1, 1))
    table = StageTable(lp)

    def limb_ops(cts):
        return lp.gather(lp.rotate(lp.rescale(lp.mult(cts[0], cts[0])), 1))

    for seed in (7, 8):
        y = keys.encrypt(np.random.default_rng(seed).uniform(-1, 1, RING // 2), seed=seed)
        plain = ev.rotate(ev.rescale(ev.mult(y, y)), 1)
        eager, limb_s, counts_e = _counted(lambda: limb_ops([lp.ingest(y)]))
        staged, graph_s, counts = _counted(lambda: table.run("limb", limb_ops, [lp.ingest(y)]))
        if not (torch.equal(eager.data, plain.data) and torch.equal(staged.data, plain.data)):
            raise AssertionError("limb-parallel mult + rescale + rotate differs from the plain one")
    if not table.graphs or table.graph_count() != 1 or table["limb"].calls != 2:
        raise AssertionError("limb-parallel: the stage did not run on a captured graph")
    print(f"# limb-parallel mult + rescale + rotate on a (1 x 1) NCCL mesh, ring 2^17: eager "
          f"{limb_s:.3f}s, a replay of its graph (all-gathers and broadcasts captured) "
          f"{graph_s:.3f}s on a new "
          f"input, each bit-equal to the plain evaluator; capture {table.capture_seconds():.2f}s "
          f"({smi})")
    _require("limb-parallel eager", counts_e)
    _require("limb-parallel replay", counts)
    _same("limb-parallel", counts, counts_e, "replayed against eager")
    del ctx, keys, srt, info, ct, outs, ev, lp, table, y, plain, eager, staged
    _release()

    # -- the sharded MEHP24 triangle
    t0 = time.time()
    ctx, keys, srt, info = large_sort.sharded_mehp24(n_mehp, mesh)
    _sync()
    setup_s = time.time() - t0
    reckoned = reports(ctx, info["reports"][0], "mehp24_sharded")
    print(f"# {info['what']}, ring 2^17: depth {info['depth']}, Lq={ctx.num_q}, "
          f"K={ctx.num_sp}, logQP {info['logqp']:.1f}; reckoned before allocating: "
          f"{reckoned[True]}; setup {setup_s:.1f}s ({smi})")
    x = np.random.default_rng(6).permutation(n_mehp) / n_mehp + 0.5 / n_mehp
    tile = large_sort.TILE
    parts = []
    for i in range(n_mehp // tile):
        pad = np.zeros(info["slots"])
        pad[:tile] = x[i * tile:(i + 1) * tile]
        parts.append(keys.encrypt(pad, slots=info["slots"]))
    outs, srt = _both_ways(
        f"sharded MEHP24 N={n_mehp}",
        lambda graphs: srt if graphs is None else ShardedMehp24(
            srt.ev, tile, len(parts), *srt.cfg, mesh=mesh, graphs=False),
        lambda s: s(parts), smi, reckoned)
    if not all(torch.equal(a.data, b.data) for a, b in zip(outs[True], outs[False])):
        raise AssertionError("sharded MEHP24: the sort on graphs differs from the eager sort")
    got = np.concatenate([keys.decrypt(c, tile) for c in outs[True]])
    err = float(np.abs(got - np.sort(x)).max())
    print(f"# sharded MEHP24 N={n_mehp}: output planes equal eager and on graphs, output level "
          f"{outs[True][0].level}; max sort error {err:.3e} (phase 12 above sorts N=512 on the "
          f"staged MEHP24) ({smi})")
    if not np.all(np.isfinite(got)) or got.shape != (n_mehp,) or not err < 0.01:
        raise AssertionError(f"sharded MEHP24: sort error {err} >= 0.01")
    del ctx, keys, srt, info, parts, outs
    _release()


def _phase17_limb_sort(smi, n=N, ranks=2):
    """The sharded DirectSort of n values on a (1 x 1) and a (1 x `ranks`)
    mesh of gloo processes on this card, eagerly, the limbs and the key
    rows split over the limb ranks (`utils.multichip.run_limb_sort`; the
    module docstring, phase 17); gloo moves the CUDA tensors through host
    memory."""
    from fhe_sorting_tpu_torch.utils import hbm_budget, multichip

    tmp = tempfile.mkdtemp(prefix="fhe_limb_")
    res = {}
    try:
        for world in (1, ranks):
            t0 = time.time()
            out = os.path.join(tmp, f"w{world}_")
            multichip.spawn(multichip.run_limb_sort, world, (n, out),
                            backend="gloo", device="cuda:0")
            res[world] = [dict(np.load(f"{out}{r}.npz")) for r in range(world)]
            r0 = res[world][0]
            print(f"# limb-parallel sharded DirectSort N={n} on (1 x {world}), {world} gloo "
                  f"process(es) on this card: ring 2^17, depth "
                  f"{int(r0['depth'])}, Lq={int(r0['num_q'])}, K={int(r0['num_sp'])}; "
                  f"{time.time() - t0:.1f}s with the processes' start ({smi})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    one = res[1][0]
    for world, rs in res.items():
        for rank, r in enumerate(rs):
            label = f"limb-parallel N={n} (1 x {world}) rank {rank}"
            report = json.loads(str(r["report"]))
            counts = json.loads(str(r["launches"]))
            ks = [int(x) for x in r["ks_planes"]]
            print(f"# {label}: setup {float(r['setup_s']):.2f}s, sort {float(r['sort_s']):.3f}s "
                  f"(the first: its plaintexts encoded on the way); "
                  f"keys {int(r['n_keys'])} x its rows = {int(r['key_bytes']) / 2**30:.3f} GiB; "
                  f"NTT/INTT planes in ModUp, ModDown, rescale {ks} = {sum(ks)}, in plaintext "
                  f"encodes {int(r['pt_planes'])}; gathered {int(r['gathered']) * 8 / 2**20:.1f} "
                  f"MiB, broadcast {int(r['broadcast']) * 8 / 2**20:.1f} MiB in "
                  f"{int(r['collectives'])} collectives ({smi})")
            _check_memory(label, report, float(r["peak_gib"]), smi)
            _require(label, counts)
            if not (np.array_equal(r["data"], one["data"])
                    and tuple(r["meta"]) == tuple(one["meta"])):
                raise AssertionError(f"{label}: the gathered output differs from one rank's")
            if world > 1:
                key_share = int(r["key_bytes"]) / int(one["key_bytes"])
                plane_share = sum(ks) / int(one["ks_planes"].sum())
                print(f"# {label}: {key_share:.3f} of one rank's key bytes, {plane_share:.3f} of "
                      f"its key-switch and rescale planes, {float(r['sort_s']) / float(one['sort_s']):.2f} "
                      f"times its sort seconds")
                if key_share > 0.55 or plane_share > 0.55:
                    raise AssertionError(f"{label}: holds {key_share:.3f} of the keys and "
                                         f"transforms {plane_share:.3f} of the planes (> 0.55)")
        err = float(rs[0]["err"])
        print(f"# limb-parallel N={n} (1 x {world}): output planes equal to one rank's, level "
              f"{int(rs[0]['meta'][0])}; max sort error {err:.3e} ({smi})")
        if not err < 0.01:
            raise AssertionError(f"limb-parallel N={n} (1 x {world}): sort error {err} >= 0.01")


def _phase14_scan(ctx2, smi):
    """ScanDirectSort eagerly and on graphs: N=128 at ring 2^17 on the per-op
    path's butterfly context (one batch), and N=64 at ring 2^12 (two
    batches: the body is replayed with its carry), each on its own keys.  The sort on graphs
    runs a warm-up (eager runs and captures, filling the plaintext memo),
    then the eager sort and a sort of replays run, each counted, so both
    find the memo warm.  Each peak is held to the budget whole; the ring-2^12 sort's,
    less what was allocated before its context was made (the ring-2^17
    context and what else other phases still hold, far more than its own
    sort needs), to its reckoning, which counts the path's fixed cost
    (`hbm_budget.FIXED_MIB`)."""
    from fhe_sorting_tpu_torch.core.context import CkksParams, Context
    from fhe_sorting_tpu_torch.core.evaluator import Evaluator
    from fhe_sorting_tpu_torch.core.keys import Keys
    from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig
    from fhe_sorting_tpu_torch.parallel.direct_scan import ScanDirectSort, scan_rotation_indices
    from fhe_sorting_tpu_torch.utils import hbm_budget
    from fhe_sorting_tpu_torch.utils.depth_meter import measure_direct_sort_depth
    from fhe_sorting_tpu_torch.utils.params_registry import direct_sort_sign_cfg

    for n, ring in ((N, RING), (64, 1 << 12)):
        cfg = SignConfig(CompositeSignConfig(*direct_sort_sign_cfg(n)))
        outside = 0.0
        if ring == RING:
            ctx = ctx2
        else:
            outside = torch.cuda.memory_allocated() / 2**30
            depth = measure_direct_sort_depth(n, ring, cfg)["mult_depth"]
            ctx = Context(CkksParams(ring_n=ring, mult_depth=depth, scale_bits=56, comp=2,
                                     base_limbs=4, ntt_impl="butterfly"))
        kset = Keys.generate(ctx, seed=0)
        kset.gen_rotation_keys(sorted(scan_rotation_indices(n, ring)))
        report = hbm_budget.check_phase(ctx, len(kset.rot), 4,
                                        work_cts=hbm_budget.WORK_CTS["direct_scan_graphs"],
                                        fixed_mib=hbm_budget.FIXED_MIB["direct_scan_graphs"],
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
        out_e, eager_s, counts_e = _counted(lambda: eager(ct))
        out, secs, counts = _counted(lambda: srt(ct))
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = kset.decrypt(out, n)
        err = float(np.abs(got - np.sort(x)).max())
        graphs = srt.graph_stats()
        print(f"# scan N={n}, ring 2^{ring.bit_length() - 1}: P={srt.P}, {srt.nb} batch(es); eager "
              f"{eager_s:.3f}s, warm-up on graphs {warm_s:.3f}s (captures "
              f"{sum(g[1] for g in graphs.values()):.2f}s), replayed {secs:.3f}s; dispatches "
              f"{ {k: g[0] for k, g in graphs.items()} }; max sort error {err:.3e}; peak "
              f"{warm_peak:.2f} GiB in the warm-up, {peak:.2f} GiB replaying, of which {held:.2f} "
              f"GiB were held before the sort, {outside:.2f} GiB of it before its context ({smi})")
        _check_memory(f"scan N={n}", report, max(warm_peak, peak), smi, outside)
        if not torch.equal(out.data, out_e.data):
            raise AssertionError(f"scan N={n}: the sort on graphs differs from the eager sort")
        _same(f"scan N={n}", counts, counts_e, "on graphs against eager")
        if not np.all(np.isfinite(got)) or got.shape != (n,) or not err < 0.01:
            raise AssertionError(f"scan N={n}: sort error {err} >= 0.01")
        _require(f"scan N={n} on graphs", counts)
        del eager, srt, ev, ct, out, out_e, kset, ctx
        _release()


def _phase15_affine(ctx, keys, ct, vals, cfg, out_ref, gather_s, smi):
    """The gather-free automorphism (`core/auto_affine.py`) on phase 5's K1
    context and keys: (a) the microbenchmark at [2, Lq, 2^17] and on one
    hoisted operand [3, Lq+K, 2^17], the affine path equal to the gather for
    rotations 1, -1, 64 and conjugation; (b) the staged N=128 sort on an
    evaluator built with FHE_AFFINE_AUTO=1, eagerly and on CUDA graphs, each
    output equal to phase 5's gather sort `out_ref` (seconds `gather_s`, by
    label: eager and on graphs); (c) the experiment
    ladder (DirectSort N=4, 8, three trials, ring 2048) and its aggregate;
    (d) the decrypt probe; (e) the rotation bench."""
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
    ways = {}
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
        out, secs, counts = _counted(lambda: srt(ct))
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = keys.decrypt(out, N)
        err = float(np.abs(got - np.sort(vals)).max())
        per_sort = {}
        for (op, *_), v in srt.stage_stats().items():
            per_sort[op] = per_sort.get(op, 0) + v // srt.stages["D"].calls
        print(f"# {label} N={N} (K1 context, FHE_AFFINE_AUTO=1): warm-up {warm_s:.3f}s, sort "
              f"{secs:.3f}s against {ref_s:.3f}s by the gather (phase 5); automorphisms a sort: "
              f"{per_sort.get('rot', 0)} rotations "
              f"(op_stats), {per_sort.get('mult_pt', 0)} plaintext products, {autos[0]} affine automorphisms "
              f"run from Python in the timed sort (0 on graphs: replays); graphs "
              f"{srt.stages.graph_count()}, captured in {srt.stages.capture_seconds():.2f}s; peak "
              f"{warm_peak:.2f} GiB in the warm-up, {peak:.2f} GiB in the sort; max sort error "
              f"{err:.3e} ({smi})")
        _check_memory(label, report, max(peak, warm_peak), smi)
        if not torch.equal(out.data, out_ref.data):
            raise AssertionError(f"{label}: output planes differ from phase 5's gather sort")
        _require(label, counts, "k1")
        ways[graphs] = counts
        if not np.all(np.isfinite(got)) or not err < 0.01:
            raise AssertionError(f"{label}: sort error {err} >= 0.01")
        del srt, out
        _release()
    _same("affine", ways[None], ways[False], "on graphs against eager")
    del ev, tables
    _release()

    # -- (c) the experiment ladder, (d) the probe, (e) the rotation bench
    tmp = tempfile.mkdtemp(prefix="fhe_ladder_")
    try:
        out_dir = os.path.join(tmp, "direct")
        rows, secs, counts = _counted(lambda: experiments.main(
            ["--algo", "direct", "--sizes", "4", "8", "--trials", "3", "--out", out_dir]))
        total = experiments.aggregate(out_dir)
        _require("ladder", counts)
        for row in total["results"]:
            print(f"# ladder row ({secs:.1f}s in all, ring 2048): {json.dumps(row)} ({smi})")
            if not 2.0 ** row["max_err_log2"] < 0.01:
                raise AssertionError(f"ladder N={row['N']}: max error 2^{row['max_err_log2']} >= 0.01")
        if [r["N"] for r in total["results"]] != [4, 8] or total["results"] != rows:
            raise AssertionError("ladder: the aggregate differs from the rows the run wrote")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res, secs, counts = _counted(lambda: probe_direct.main(["--n", "16", "--ring", "4096"]))
    print(f"# probe DirectSort N=16, ring 2^12: rank error {res['rank_err']:.3e}, sort error "
          f"{res['sort_err']:.3e}, constructRank {res['t_rank_s']:.3f}s, rotationIndexCheckN "
          f"{res['t_idx_s']:.3f}s ({smi})")
    if not res["sort_err"] < 0.01:
        raise AssertionError(f"probe: sort error {res['sort_err']} >= 0.01")
    _require("probe", counts)
    res, secs, counts = _counted(lambda: rotation_bench.main(
        ["--ring", "4096", "--chains", "1", "5", "10"]))
    print(f"# rotation bench, ring 2^12: {json.dumps(res['results'])} ({smi})")
    _require("rotation bench", counts)


def _phase16_entry_points(smi):
    """The port's entry points for the system's own measurements, each run
    as a user runs it: (a) the NTT microbenchmark (`utils/ntt_bench.py`) at
    its defaults, every transform, forward and inverse, bit-equal to the
    plain butterfly; (b) K1 held to its plain version on the bootstrap
    harness's chain with the four-step NTT named, then the harness
    (`utils/run_bootstrap.py`) at its defaults, ring 2^14 under a sparse
    secret on the default NTT (K2), max error below 1e-2, its refresh
    counted; (c) K3 against its plain versions at
    the top of `direct_n128`'s chain (`_k3_check`), and K4 against its plain
    version at the top of `mehp24_n512`'s and `direct_n128`'s (`_k4_check`).
    Returns K1's largest difference from its plain version, and K3's and
    K4's records; the launches of the NTT bench and of the checks only time
    and compare the kernels, and are not counted."""
    from fhe_sorting_tpu_torch.core import fs_ntt, ntt_mxu
    from fhe_sorting_tpu_torch.utils import ntt_bench, run_bootstrap

    # -- (a) the NTT microbenchmark; its launches compare and time, uncounted
    buf = io.StringIO()
    t0 = time.time()
    _quiet(buf, lambda: ntt_bench.main([]))
    for line in buf.getvalue().strip().splitlines():
        print(f"# ntt_bench | {line}")
    exact = [line for line in buf.getvalue().splitlines() if line.startswith("bit-exact match")]
    if len(exact) != 6 or not all(line.endswith(": True") for line in exact):
        raise AssertionError(f"ntt_bench: {exact}")
    print(f"# ntt_bench at its defaults: {time.time() - t0:.1f}s")
    _release()

    # -- (b) the bootstrap harness at its defaults (ring 2^14, K2), after K1
    # against its plain version on that chain (n1 = n2 = 128), the four-step
    # NTT named: every prime, and the key switch's extended set at the
    # refresh's input level
    args = run_bootstrap.parser().parse_args([])
    bctx = run_bootstrap.context(args.ring, args.depth, run_bootstrap.HAMMING, ntt_impl="mxu")
    ring, tabs = bctx.params.ring_n, bctx.tables
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
        out, secs, counts = _counted(lambda: _quiet(buf, lambda: run_bootstrap.main(
            ["--out", os.path.join(tmp, "level_budgets.json")])))
        print(f"# run_bootstrap row: {buf.getvalue().strip()} ({smi})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"# run_bootstrap: {secs:.1f}s in all")
    if not out["max_err"] < 1e-2:
        raise AssertionError(f"run_bootstrap: max error {out['max_err']} >= 1e-2")
    _require("run_bootstrap", counts)
    return k1_err, _k3_check(smi), _k4_check(smi)


def _k3_check(smi):
    """K3 against its plain versions on the card, bit for bit, at the top of
    `direct_n128`'s chain (ring 2^17, depth 32, prime pairs: Lq 68, K 23):
    the first rescale's lift [2, 1, n] -> [2, 67, n] and division of a
    [:, :67] view of [2, 68, n] planes, and ModDown's division at level 0 of
    a [..., :68, :] view of [2, 91, n]; the coefficients hold the centring's
    edges.  Times each launch (device, a mean of 20 after a warm-up) beside
    its byte bound at 3.35 TB/s, and the plain PyTorch chain it replaced;
    its launches are not counted.  Returns K3's record for the kernels'
    JSON, with the largest difference from the plain versions."""
    from fhe_sorting_tpu_torch.core import rns_div
    from fhe_sorting_tpu_torch.core.context import CkksParams, Context
    from fhe_sorting_tpu_torch.utils.roofline import H100

    ctx = Context(CkksParams(ring_n=RING, mult_depth=32, scale_bits=56, comp=2, base_limbs=4,
                             dnum=3, ntt_impl="butterfly"))
    rows, ks = ctx.rescale_rows(0), ctx.ks_rows(0)
    Lq, r, q = ctx.num_q, ctx.num_q - 1, ctx.q_primes[-1]
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(17)
    x = torch.randint(0, q, (2, 1, RING), generator=gen, device=ctx.device)
    half = rows.qlast_half
    x[0, 0, :5] = torch.tensor([0, 1, half - 1, half, q - 1], device=ctx.device)
    data = _rand_residues(gen, (2, Lq, RING), ctx.p_active(0))
    b = _rand_residues(gen, (2, r, RING), rows.p)
    c = _rand_residues(gen, (2, Lq + ctx.num_sp, RING), ks.p_target)
    ext = _rand_residues(gen, (2, Lq, RING), ks.p_active)
    calls = {
        "lift": (lambda: rns_div.lift(x, rows.p, rows.qlast_mod_qi, half),
                 lambda: rns_div.lift_plain(x, rows.p, rows.qlast_mod_qi, half), 8 * 2 * r),
        "rescale sub_scale": (
            lambda: rns_div.sub_scale(data[:, :r], b, rows.p, rows.qlast_inv),
            lambda: rns_div.sub_scale_plain(data[:, :r], b, rows.p, rows.qlast_inv), 24 * 2 * r),
        "ModDown sub_scale": (
            lambda: rns_div.sub_scale(c[..., :Lq, :], ext, ks.p_active, ks.p_inv_mod_qi),
            lambda: rns_div.sub_scale_plain(c[..., :Lq, :], ext, ks.p_active, ks.p_inv_mod_qi),
            24 * 2 * Lq),
    }
    ms, plain_ms, bound_ms, err = {}, {}, {}, 0
    for name, (kernel, plain, nbytes) in calls.items():
        got, want = kernel(), plain()
        _sync()
        diff = int((got - want).abs().max())
        err = max(err, diff)
        if not torch.equal(got, want):
            raise AssertionError(f"K3 {name} disagrees with its plain version: max |diff| {diff}")
        ms[name] = _time_ms(kernel, 20)
        plain_ms[name] = _time_ms(plain, 5)
        bound_ms[name] = nbytes * RING / H100.hbm_bytes_s * 1e3
        print(f"# K3 {name} == plain at [2, {got.shape[1]}, 2^17] (direct_n128's top, "
              f"{'a strided view' if name != 'lift' else 'edges of the centring'}): kernel "
              f"{ms[name]:.4f} ms, byte bound {bound_ms[name]:.4f} ms "
              f"({100 * bound_ms[name] / ms[name]:.1f}% of it), the plain PyTorch chain "
              f"{plain_ms[name]:.4f} ms ({smi})")
    del ctx, data, b, c, ext, x
    _release()
    rescale = ("lift", "rescale sub_scale")
    print(f"# K3 one dropped limb's rescale at direct_n128's top: kernels "
          f"{sum(ms[k] for k in rescale):.4f} ms against {sum(plain_ms[k] for k in rescale):.4f} "
          f"ms by the plain chain; bound {sum(bound_ms[k] for k in rescale):.4f} ms")
    return {"ms": sum(ms[k] for k in rescale), "plain_ms": sum(plain_ms[k] for k in rescale),
            "bound_ms": sum(bound_ms[k] for k in rescale), "moddown_ms": ms["ModDown sub_scale"],
            "moddown_plain_ms": plain_ms["ModDown sub_scale"],
            "moddown_bound_ms": bound_ms["ModDown sub_scale"], "max_abs_err": err}


def _k4_check(smi):
    """K4 against its plain version on the card, bit for bit: the top ModUp
    and ModDown of `mehp24_n512`'s chain (ring 2^17, depth 46, dnum 4: Lq 96
    in four digits of 24, K 24; [1, 96, n] -> [4, 120, n] and [2, 24, n] ->
    [2, 96, n], the latter read from a strided view) and the top ModUp of
    `direct_n128`'s (Lq 68 in digits of 23, 23 and 22, K 23), on residues
    with p - 1 in every row.  Times each launch (device, a mean of 20 after a
    warm-up) beside its byte bound at 3.35 TB/s, with 8-byte and with 4-byte
    residues (each input read once, each output written once), and the plain
    PyTorch chain it replaced; its launches are not counted.  Returns K4's
    record for the kernels' JSON, with the largest difference from the plain
    version."""
    from fhe_sorting_tpu_torch.core import rns_bconv
    from fhe_sorting_tpu_torch.core.context import CkksParams, Context
    from fhe_sorting_tpu_torch.utils.roofline import H100

    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)

    def planes(shape, p):
        x = _rand_residues(gen, shape, p)
        x[..., 0] = (p - 1)[:, 0]
        return x

    calls = {}
    for name, depth, dnum in (("mehp24_n512", 46, 4), ("direct_n128", 32, 3)):
        ctx = Context(CkksParams(ring_n=RING, mult_depth=depth, scale_bits=56, comp=2,
                                 base_limbs=4, dnum=dnum, ntt_impl="butterfly"))
        ks, Lq, K = ctx.ks_rows(0), ctx.num_q, ctx.num_sp
        digits = ctx.digit_layout(0)
        x = planes((1, Lq, RING), ctx.p_active(0))
        up = (x, ks.dhat_inv, ctx.p_active(0), ks.dig_ext, ks.p_target, digits)
        calls[f"{name} ModUp"] = (up, (Lq + len(digits) * (Lq + K)) * RING)
        if name == "mehp24_n512":
            wide = planes((2, K + 3, RING), torch.cat([ctx.p_special()[:3], ctx.p_special()]))
            down = (wide[:, 3:], ks.phat_inv, ctx.p_special(), ks.pext, ks.p_active, ((0, K),))
            calls[f"{name} ModDown"] = (down, 2 * (K + Lq) * RING)
    ms, plain_ms, bound_ms, bound4_ms, err = {}, {}, {}, {}, 0
    for name, (args, residues) in calls.items():
        got, want = rns_bconv.base_extend(*args), rns_bconv.base_extend_plain(*args)
        _sync()
        diff = int((got - want).abs().max())
        err = max(err, diff)
        if not torch.equal(got, want):
            raise AssertionError(f"K4 {name} disagrees with its plain version: max |diff| {diff}")
        ms[name] = _time_ms(lambda: rns_bconv.base_extend(*args), 20)
        plain_ms[name] = _time_ms(lambda: rns_bconv.base_extend_plain(*args), 5)
        bound_ms[name] = 8 * residues / H100.hbm_bytes_s * 1e3
        bound4_ms[name] = bound_ms[name] / 2
        print(f"# K4 {name} == plain, {tuple(args[0].shape)} -> {tuple(got.shape)}"
              f"{' (a strided view)' if not args[0].is_contiguous() else ''}: kernel "
              f"{ms[name]:.4f} ms, byte bound {bound_ms[name]:.4f} ms at 8-byte residues "
              f"({100 * bound_ms[name] / ms[name]:.1f}% of it), {bound4_ms[name]:.4f} ms at 4-byte, "
              f"the plain PyTorch chain {plain_ms[name]:.4f} ms ({smi})")
    del calls, args, got, want
    _release()
    up, down = "mehp24_n512 ModUp", "mehp24_n512 ModDown"
    return {"ms": ms[up], "plain_ms": plain_ms[up], "bound_ms": bound_ms[up],
            "bound_ms_4byte": bound4_ms[up], "moddown_ms": ms[down],
            "moddown_plain_ms": plain_ms[down], "moddown_bound_ms": bound_ms[down],
            "max_abs_err": err}


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
    import importlib

    from fhe_sorting_tpu_torch.core import bf_ntt, fs_ntt, ntt, ntt_mxu
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

    # -- phase 2: build K1 to K4 ----------------------------------------------
    t0 = time.time()
    sources = [k.source for k in cuda_build.KERNELS.values()]
    cuda_build.build(sources)
    for name in sources:
        importlib.import_module(f"fhe_sorting_tpu_torch.core.{name}").load()
    print(f"# K1 + K2 + K3 + K4 build (in parallel) + load: {time.time() - t0:.2f}s")
    for name, (secs, report) in cuda_build.reports.items():
        print(f"# nvcc {name}.cu: {secs:.2f}s")
        print("# " + report.strip().replace("\n", "\n# "))

    # -- phase 3: K1 against its plain version ---------------------------------
    # the N=128 chain (`profile_sort.sort_context`): the metered depth,
    # which the per-op sort needs too; the four-step NTT named, since "auto"
    # is the butterfly on the card
    t0 = time.time()
    ctx, cfg, depth = sort_context(N, "staged", "mxu")
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
    # the same chain with the default NTT ("auto"), which is K2 on the card
    t0 = time.time()
    ctx2 = sort_context(N, "staged", depth=depth)[0]
    ctx2_s = time.time() - t0
    if ctx2.ntt_impl != "butterfly" or not isinstance(ctx2.tables, ntt.NttTables):
        raise AssertionError(f"the default NTT on the card is {ctx2.ntt_impl}, not K2")
    assert ctx2.all_primes == ctx.all_primes
    print(f"# default (butterfly) context: same chain, {ctx2_s:.1f}s")
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
                                         srt.index_check, smi, report))
        print(f"# {label}: stage calls: { {name: st.calls for name, st in srt.stages.items()} }")
        _require(label, staged[label][1], "k1")
        del srt
        _release()
    (_, counts_e, eager_s, _, out_e, _), (
        srt, counts, staged_s, phase_s, out_g, (warm_s, warm_peak, peak)) = staged.values()
    if not torch.equal(out_e.data, out_g.data):
        raise AssertionError("staged: the sort on graphs differs from the eager sort")
    _same("staged", counts, counts_e, "on graphs against eager")
    print(f"# staged N={N} on K1: eager {eager_s:.3f}s, on graphs {staged_s:.3f}s (output planes "
          f"equal); {srt.stages.graph_count()} graphs, captured in {srt.stages.capture_seconds():.2f}s "
          f"of a {warm_s:.2f}s warm-up sort; K1 launches a sort {counts['k1']} (replay tallies); "
          f"peak {warm_peak:.2f} GiB in the warm-up, {peak:.2f} GiB replaying ({smi})")
    _roofline_line(ctx, srt, phase_s, smi)
    del staged, srt, ev, out_e
    _release()

    # -- phase 15: the gather-free automorphism on phase 5's context and keys
    _phase15_affine(ctx, keys, ct, vals, cfg, out_g, (eager_s, staged_s), smi)
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
    counts, per_op_s, *_ = _run_sort(
        "per-op", keys, keys.encrypt(vals), vals,
        lambda ct: srt.sort(ct, SignFunc.CompositeSign, cfg),
        lambda ct: srt.construct_rank(ct, SignFunc.CompositeSign, cfg),
        srt.rotation_index_check_n, smi, report)
    _require("per-op", counts)
    print(f"# per-op: over the three sorts: {srt.rot.stats}")
    print(f"# sorts side by side: staged on K1 {staged_s:.3f}s on graphs, {eager_s:.3f}s "
          f"eager; per-op on K2 {per_op_s:.3f}s ({smi})")
    del srt, ev

    # -- phases 7-14: the serving path, the scan sorts, what stands behind the
    # server, the k-way network, the staged N>256 regimes, the sharded sorts ---
    _phase7_serve(ctx2, keys, smi)
    del keys
    _release()
    _phase14_scan(ctx2, smi)
    del ctx2, bf, k2
    _release()
    for phase in (_phase8_bootstrap, _phase9_bitonic, _phase10_mehp24, _characterizer_line,
                  _phase11_kway, _phase12_staged_large, _phase13_sharded, _phase17_limb_sort):
        phase(smi)
        _release()
    # -- phase 16: the entry points of the system's own measurements --------
    k1_err16, k3, k4 = _phase16_entry_points(smi)
    k1_err = max(k1_err, k1_err16)
    _release()
    launches = {key: sum(c[key] for c in RUNS.values()) for key in cuda_build.KERNELS}
    print(f"# launches by counted run: {json.dumps(RUNS)}; in all {launches}; the largest "
          f"difference from the plain versions of K3 {k3['max_abs_err']}, of K4 "
          f"{k4['max_abs_err']} (phase 16)")

    print(json.dumps({"kernels": [
        {"name": "fs_ntt (four-step NTT, K1)", "route": "cuda",
         "source": "fhe_sorting_tpu_torch/csrc/fs_ntt.cu",
         "replaces": "fhe_sorting_tpu/core/pallas_fs_ntt.py:97",
         "launches": launches["k1"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": bound[0], "bound_by": bound[1], "form_ops_ms": k1_form_ms,
         "library_ms": None},
        {"name": "bf_ntt (butterfly NTT, K2)", "route": "cuda",
         "source": "fhe_sorting_tpu_torch/csrc/bf_ntt.cu",
         "replaces": "fhe_sorting_tpu/core/pallas_ntt.py:66",
         "launches": launches["k2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": bound[0], "bound_by": bound[1], "form_ops_ms": k2_form_ms,
         "library_ms": None},
        {"name": "rns_div (exact division by a dropped modulus, K3; one dropped limb's rescale "
                 "at direct_n128's top, [2, 67, 2^17])", "route": "cuda",
         "source": "fhe_sorting_tpu_torch/csrc/rns_div.cu", "replaces": None,
         "launches": launches["k3"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": "bytes", "form_ops_ms": None, "library_ms": None,
         "moddown_ms": k3["moddown_ms"], "moddown_plain_ms": k3["moddown_plain_ms"],
         "moddown_bound_ms": k3["moddown_bound_ms"]},
        {"name": "rns_bconv (the key switch's base extension, K4; the top ModUp of "
                 "mehp24_n512, [96, 2^17] -> [4, 120, 2^17])", "route": "cuda",
         "source": "fhe_sorting_tpu_torch/csrc/rns_bconv.cu", "replaces": None,
         "launches": launches["k4"], "max_abs_err": k4["max_abs_err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": "bytes", "bound_ms_4byte": k4["bound_ms_4byte"], "form_ops_ms": None,
         "library_ms": None, "moddown_ms": k4["moddown_ms"],
         "moddown_plain_ms": k4["moddown_plain_ms"], "moddown_bound_ms": k4["moddown_bound_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
