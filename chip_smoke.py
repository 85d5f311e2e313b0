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
     -> Keys -> Evaluator -> StagedDirectSort at N=128, a warm-up sort then a
     timed one, decrypt, and require max error < 0.01 against np.sort and a
     K1 launch count > 0 for the timed sort;
  6. drive the per-op path the same way on a butterfly context:
     DirectSort(ev, 128).sort over the full key set, and require K2
     launches > 0 and K1 launches == 0 for the timed sort.
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
     < 0.01.
Phases 7-10 run butterfly contexts at ring 2^17: each must launch K2 and
never K1, with the counts set to 0 just before and read just after.
The last two lines are the kernels' JSON record and {"ok": true, ...}.

Bounds in the JSON record: `bound_ms` is the least time the card could take
for the function, a negacyclic NTT of the planes, whatever algorithm a kernel
chose: the larger of the bytes it must move (data in, data out, one [L, n]
twiddle table) over the card's 3.35 TB/s and the (n/2) log2(n) butterflies a
plane, ten 32-bit integer operations each, over 67 T op/s (the published
float32 rate of the CUDA cores, a multiply-add counted as two; no separate
integer rate is published, and integer multiply-add runs no faster).  K1 and
K2 compute the same function, so they share one bound.  `form_ops_ms` is the
arithmetic of the kernel's own algorithm over the same rate: the four-step
form of K1 does n (n1 + n2) multiply-adds a plane, far more than the function
needs, and that excess is the kernel's to answer for, not part of its bound.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
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
    return ops / CUDA_CORE_OPS_PER_S * 1e3


def _ntt_bound(planes: int, limbs: int, n: int):
    """(ms, "bytes" or "operations"): the least time for a negacyclic NTT of
    `planes` int64 planes of n residues over `limbs` primes."""
    by_bytes = (2 * planes * n * 8 + limbs * n * 8) / HBM_BYTES_PER_S * 1e3
    # a butterfly: one product, its reduction (two more), an add and a subtract
    # with their conditional corrections: ten 32-bit integer operations
    by_ops = _ops_ms(10.0 * planes * (n // 2) * (n.bit_length() - 1))
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations"), by_ops


def _run_sort(label, keys, vals, sort, phase1, phase2, counters, smi):
    """A warm-up sort, then a timed one, both through the entry point `sort`;
    every kernel's count is set to 0 just before the timed sort and read just
    after, and the error is that sort's.  A third sort, uncounted, runs the
    entry point's two phases by hand for their seconds."""
    ct = keys.encrypt(vals)
    t0 = time.time()
    sort(ct)
    _sync()
    print(f"# {label}: warm-up sort {time.time() - t0:.2f}s")
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
    print(f"# {label}: max sort error {err:.3e}; peak device memory {peak:.2f} GiB ({smi})")
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
    return counts, total


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
              f"{err:.3e}; peak device memory {peak:.2f} GiB ({smi})")
        if not np.all(np.isfinite(got)) or got.shape != (N,):
            raise AssertionError("serve: output is not N finite values")
        if not err < 0.01:
            raise AssertionError(f"serve: sort error {err} >= 0.01")
        return _require_k2_only("serve", counts)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the EvalMod shapes of phases 8 and 9: K bounds the q0-multiple I of the
# secret in use, the double-angle count keeps the fitted range K / 2^r at 32
# (uniform) or 3.25 (sparse)
BOOT_UNIFORM = dict(K=512.0, sin_degree=270, double_angle=4, asin_terms=3)
BOOT_SPARSE = dict(K=13.0, sin_degree=64, double_angle=2, asin_terms=3)


def _boot_env(depth, hamming, shape, budget, smi, label, pt_cache_bytes=None, n_cts=4):
    """Context, keys (conjugation + the power-of-two basis), evaluator,
    composer and Bootstrapper of one bootstrap configuration; the memory is
    reckoned before anything is allocated.  `pt_cache_bytes` bounds the
    evaluator's plaintext memo (None: its default)."""
    from fhe_sorting_tpu_torch.core.bootstrap import Bootstrapper
    from fhe_sorting_tpu_torch.core.context import CkksParams, Context
    from fhe_sorting_tpu_torch.core.evaluator import Evaluator
    from fhe_sorting_tpu_torch.core.keys import Keys
    from fhe_sorting_tpu_torch.ops.rotation import RotationComposer
    from fhe_sorting_tpu_torch.utils import hbm_budget

    t0 = time.time()
    ctx = Context(CkksParams(ring_n=RING, mult_depth=depth, scale_bits=56, comp=2,
                             base_limbs=4, first_mod_bits=30, secret_hamming=hamming,
                             ntt_impl="butterfly"))
    logqp = sum(np.log2(float(p)) for p in ctx.all_primes)
    basis = sorted({1 << i for i in range(RING.bit_length() - 2)})
    lazy = 8
    # resident: the basis, the conjugation key, the lazy pool
    report = hbm_budget.check_phase(ctx, len(basis) + 1 + lazy, n_cts, label=label)
    print(f"# {label}: depth {depth}, Lq={ctx.num_q}, K={ctx.num_sp}, logQP={logqp:.0f}; "
          f"reckoned before allocating: {report}")
    keys = Keys.generate(ctx, seed=0)
    keys.gen_conj_key()
    ev = Evaluator(ctx, keys, **({} if pt_cache_bytes is None else
                                 {"pt_cache_bytes": pt_cache_bytes}))
    rot = RotationComposer(ev, basis, lazy_key_budget=lazy)
    bs = Bootstrapper(ev, level_budget=budget, rot=rot, **shape)
    keys.gen_rotation_keys(basis)
    _sync()
    print(f"# {label}: context, keys ({len(keys.rot)} resident) and the factored transforms "
          f"{time.time() - t0:.1f}s; {len(bs.required_rotations())} distinct BSGS rotations, "
          f"{sum(len(lt.diags) for lt in bs.c2s)} C2S diagonals")
    return ctx, keys, ev, rot, bs, report


def _bootstrap_once(counters, smi, label, depth, hamming, shape):
    """Two refreshes of 2^16 values in [0, 1].  The first, on an empty
    plaintext memo, is the bootstrap's time: it encodes every diagonal on the
    host, as every refresh does under the evaluator's default memo, which holds
    a fraction of one refresh's plaintexts.  The second shows what a memo
    that holds them all (24 GiB here) saves.  Returns (max error, K2 launches)
    of the second after checking everything but the error."""
    ctx, keys, ev, rot, bs, report = _boot_env(depth, hamming, shape, (3, 3), smi, label,
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
          f"{ev.pt_stats['encode_s']:.2f}s of host encoding in the second refresh; peak device "
          f"memory {peak:.2f} GiB measured, {report['used_gb']} GB reckoned for keys and "
          f"ciphertexts ({smi})")
    if not out.level + (out.sdeg == 2) <= depth - 2:
        raise AssertionError(f"bootstrap: fewer than two levels left (level {out.level})")
    if not out.level < ct_low.level:
        raise AssertionError("bootstrap: the level was not refreshed")
    return float(err.max()), _require_k2_only("bootstrap", counts)


def _phase8_bootstrap(counters, smi):
    """One bootstrap at ring 2^17.  The uniform-ternary-secret shape is the
    asserted one; if it cannot meet 1e-2 at this ring, its error is reported
    and the sparse-secret shape is run and asserted instead."""
    # the uniform shape's refresh ends at level 30 (scale degree 2), the sparse
    # shape's at 24: each depth leaves two levels
    err, k2 = _bootstrap_once(counters, smi, "bootstrap (uniform ternary secret)", 33, None,
                              BOOT_UNIFORM)
    if not err < 1e-2:
        print(f"# bootstrap: the uniform-secret shape reaches max error {err:.3e}, not 1e-2, at "
              f"ring 2^17: the sparse-secret shape is the asserted one")
        _release()
        err, k2 = _bootstrap_once(counters, smi, "bootstrap (sparse secret, hamming 64)", 27, 64,
                                  BOOT_SPARSE)
    if not err < 1e-2:
        raise AssertionError(f"bootstrap: max error {err} >= 1e-2")
    return k2


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
    ctx, keys, ev, rot, bs, _ = _boot_env(depth, 64, BOOT_SPARSE, (3, 3), smi,
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
          f"lazy keygens {rot.stats.lazy_keygens}; peak device memory {peak:.2f} GiB ({smi})")
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
    report = hbm_budget.check_phase(ctx, len(steps), 6, label=f"MEHP24 N={n}")
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
          f"max sort error {err:.3e}; rotations {srt.rot.stats.rotations}; peak device memory "
          f"{peak:.2f} GiB measured, {report['used_gb']} GB reckoned ({smi})")
    if not np.all(np.isfinite(got)) or got.shape != (n,):
        raise AssertionError("mehp24: output is not N finite values")
    if not err < 0.01:
        raise AssertionError(f"mehp24: sort error {err} >= 0.01")
    return _require_k2_only("mehp24", counts)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from fhe_sorting_tpu_torch.core import bf_ntt, cuda_build, fs_ntt, ntt, ntt_mxu
    from fhe_sorting_tpu_torch.core import primes as primes_mod
    from fhe_sorting_tpu_torch.core.context import CkksParams, Context
    from fhe_sorting_tpu_torch.core.evaluator import Evaluator
    from fhe_sorting_tpu_torch.core.keys import Keys
    from fhe_sorting_tpu_torch.models.direct_sort import DirectSort, rotation_indices_direct_sort
    from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig, SignFunc
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
    cn, dg, df = direct_sort_sign_cfg(N)
    cfg = SignConfig(CompositeSignConfig(cn, dg, df))
    depth = measure_direct_sort_depth(N, RING, cfg)["mult_depth"]
    assert depth == measure_direct_sort_depth(N, RING, cfg, staged=False)["mult_depth"]
    params = dict(ring_n=RING, mult_depth=depth, scale_bits=56, comp=2, base_limbs=4, dnum=3)
    t0 = time.time()
    ctx = Context(CkksParams(**params))
    ctx_s = time.time() - t0
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
    ctx2 = Context(CkksParams(**params, ntt_impl="butterfly"))
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

    # -- phase 5: the staged path (four-step context, K1) ----------------------
    t0 = time.time()
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys(sorted(scan_rotation_indices(N, RING)))
    srt = StagedDirectSort(Evaluator(ctx, keys), N, cfg)
    _sync()
    print(f"# staged: keys ({len(keys.rot)} rotation + relin) {time.time() - t0:.2f}s")
    (k1_launches, k2_stray), staged_s = _run_sort(
        "staged", keys, vals, srt, srt.construct_rank, srt.index_check,
        (fs_ntt, bf_ntt), smi)
    print(f"# staged: K1 launches {k1_launches}, K2 launches {k2_stray}; "
          f"stage calls: { {name: st.calls for name, st in srt.stages.items()} }")
    if k1_launches <= 0 or k2_stray != 0:
        raise AssertionError("the staged path must launch K1 and not K2")
    del srt, keys, ctx, fs, k1
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 6: the per-op path (butterfly context, K2) ----------------------
    t0 = time.time()
    keys = Keys.generate(ctx2, seed=0)
    steps = sorted(rotation_indices_direct_sort(N, RING))
    keys.gen_rotation_keys(steps)
    ev = Evaluator(ctx2, keys)
    srt = DirectSort(ev, N)
    _sync()
    print(f"# per-op: keys ({len(keys.rot)} rotation + relin) {time.time() - t0:.2f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    (k1_stray, k2_launches), per_op_s = _run_sort(
        "per-op", keys, vals,
        lambda ct: srt.sort(ct, SignFunc.CompositeSign, cfg),
        lambda ct: srt.construct_rank(ct, SignFunc.CompositeSign, cfg),
        srt.rotation_index_check_n, (fs_ntt, bf_ntt), smi)
    print(f"# per-op: K2 launches {k2_launches}, K1 launches {k1_stray}; "
          f"over the three sorts: {srt.rot.stats}")
    if k2_launches <= 0 or k1_stray != 0:
        raise AssertionError("the per-op butterfly path must launch K2 and not K1")
    print(f"# sorts side by side: staged on K1 {staged_s:.3f}s, per-op on K2 {per_op_s:.3f}s "
          f"({smi})")
    del srt, ev

    # -- phases 7-10: the serving path and what stands behind it ---------------
    counters = (fs_ntt, bf_ntt)
    by_phase = {"per-op sort": k2_launches}
    by_phase["serve"] = _phase7_serve(ctx2, keys, counters, smi)
    del keys, ctx2, bf, k2
    _release()
    for name, phase in (("bootstrap", _phase8_bootstrap), ("bitonic", _phase9_bitonic),
                        ("mehp24", _phase10_mehp24)):
        by_phase[name] = phase(counters, smi)
        _release()
    k2_launches = sum(by_phase.values())
    print(f"# K2 launches by phase: {by_phase}; K1 launches: staged sort {k1_launches}")

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
