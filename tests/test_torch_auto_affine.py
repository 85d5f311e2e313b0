"""The port's gather-free automorphism (`core/auto_affine.py`) against the JAX
package's and against the gather.

At ring 512 (the tests/test_auto_affine.py shape): the tables and per-g
selector matrices equal the JAX ones entry for entry (the JAX tables
recombined from their balanced s8 digits); `apply_affine` equals the JAX
`apply_affine` and the gather `x[..., perm]` bit for bit, for rotations,
negative rotations and conjugation, on the four-step split and another grid.
Through the evaluator, with `FHE_AFFINE_AUTO=force`, the four automorphism
consumers (rotate, hoisted rotate, the plaintext roll of `mult_plain_at`,
conjugate) give planes equal to the port's gather path and to the JAX affine
evaluator's on the same keys, and so does the staged N=8 sort.  Tolerance
0 throughout: the automorphism is exact."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core import auto_affine as jaa
from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu.ops.sign import CompositeSignConfig as JCompositeSignConfig
from fhe_sorting_tpu.ops.sign import SignConfig as JSignConfig
from fhe_sorting_tpu.parallel.direct_staged import StagedDirectSort as JStagedDirectSort
from fhe_sorting_tpu_torch.core import auto_affine
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context, FrozenError
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.core.ntt_mxu import split_n
from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig
from fhe_sorting_tpu_torch.parallel.direct_staged import StagedDirectSort, scan_rotation_indices
from fhe_sorting_tpu_torch.utils.depth_meter import measure_direct_sort_depth

torch.set_num_threads(2)

RING = 512
PARAMS = dict(ring_n=RING, mult_depth=4)
SPLIT = split_n(RING)[0]
ROTATIONS = [1, 2, 5, -1, -7, 100, 255]
# galois elements by name: the rotations above and conjugation
GALOIS = {f"rot{r}": r for r in ROTATIONS} | {"conj": None}


@pytest.fixture(scope="module")
def ctxs():
    return JContext(JParams(**PARAMS)), Context(CkksParams(**PARAMS), device="cpu")


def _galois(tc, r):
    return 2 * RING - 1 if r is None else tc.galois_element_rot(r)


def _digits(d):
    d = np.asarray(d).astype(np.int64)
    return sum(d[i] << (8 * i) for i in range(4))


def _residues(ctx, seed, batch=2):
    rng = np.random.default_rng(seed)
    return np.stack([np.stack([rng.integers(0, p, size=RING) for p in ctx.all_primes])
                     for _ in range(batch)])


@pytest.mark.parametrize("n1", [8, SPLIT, 32])
def test_tables_match_jax(ctxs, n1):
    jc, tc = ctxs
    jt = jaa.build_tables(tuple(jc.all_primes), RING, n1)
    tt = auto_affine.build_tables(tuple(tc.all_primes), RING, n1, "cpu")
    np.testing.assert_array_equal(tt.p.numpy(), np.asarray(jt.p).astype(np.int64))
    for f in ("fb", "fib", "wneg"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), _digits(getattr(jt, f)), f)
    # the float64 forms the products read
    two16 = 1 << 16
    np.testing.assert_array_equal((tt.fbt_lo + two16 * tt.fbt_hi).long(), tt.fb.transpose(1, 2))
    np.testing.assert_array_equal((tt.fibt_lo + two16 * tt.fibt_hi).long(), tt.fib.transpose(1, 2))
    np.testing.assert_array_equal(tt.wneg_f.long(), tt.wneg)


@pytest.mark.parametrize("n1", [8, SPLIT])
@pytest.mark.parametrize("name", sorted(GALOIS))
def test_consts_match_jax(ctxs, name, n1):
    _, tc = ctxs
    g = _galois(tc, GALOIS[name])
    jcs = jaa.build_consts(g, RING, n1)
    tcs = auto_affine.build_consts(g, RING, n1, "cpu")
    for f in ("row", "lam", "hot_a"):
        np.testing.assert_array_equal(getattr(tcs, f).numpy(), np.asarray(getattr(jcs, f)), f)


@pytest.mark.parametrize("n1", [8, SPLIT])
@pytest.mark.parametrize("name", sorted(GALOIS))
def test_apply_affine_matches_jax_and_gather(ctxs, name, n1):
    jc, tc = ctxs
    g = _galois(tc, GALOIS[name])
    x = _residues(tc, seed=n1 + (GALOIS[name] or 0) % 251)
    perm = tc.galois_perm(g)
    tt = auto_affine.build_tables(tuple(tc.all_primes), RING, n1, "cpu")
    tcs = auto_affine.build_consts(g, RING, n1, "cpu")
    got = auto_affine.apply_affine(torch.from_numpy(x), tcs, tt)
    want = jaa.apply_affine(x.astype(np.uint32), jaa.build_consts(g, RING, n1),
                            jaa.build_tables(tuple(jc.all_primes), RING, n1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), x[..., perm.numpy()])
    # one plane set alone (a plaintext's [L, n]) and a limb subset by index
    np.testing.assert_array_equal(auto_affine.apply_affine(torch.from_numpy(x[0]), tcs, tt).numpy(),
                                  x[0][..., perm.numpy()])
    limbs = torch.tensor([0, 3, len(tc.all_primes) - 1])
    sub = torch.from_numpy(x[:, limbs.numpy()])
    for t in (tt.select(limbs), tt.take(limbs.numpy())):
        np.testing.assert_array_equal(auto_affine.apply_affine(sub, tcs, t).numpy(),
                                      sub[..., perm].numpy())
    np.testing.assert_array_equal(
        auto_affine.apply_affine(torch.from_numpy(x[:, :2]), tcs, tt.slice(0, 2)).numpy(),
        x[:, :2][..., perm.numpy()])


@pytest.mark.parametrize("env,ntt_impl,on", [
    ("0", "mxu", False), ("1", "butterfly", False), ("1", "mxu", True),
    ("force", "butterfly", True), (None, "mxu", False)])
def test_use_affine_rule(monkeypatch, env, ntt_impl, on):
    """The JAX package's rule: "force" on any context, "1" on four-step
    contexts only; unset is the gather."""
    if env is None:
        monkeypatch.delenv("FHE_AFFINE_AUTO", raising=False)
    else:
        monkeypatch.setenv("FHE_AFFINE_AUTO", env)
    ctx = Context(CkksParams(ring_n=256, mult_depth=2, ntt_impl=ntt_impl), device="cpu")
    ev = Evaluator(ctx, Keys.generate(ctx, seed=0))
    assert ev.use_affine is on
    assert (ctx._auto_tables is not None) is on


@pytest.fixture(scope="module")
def evs(ctxs):
    """The JAX affine evaluator and the port's gather and affine evaluators,
    all on the JAX keys."""
    jc, tc = ctxs
    jk = JKeys.generate(jc, seed=7)
    jk.gen_rotation_keys([1, 2, -3, 5])
    jk.gen_conj_key()
    tk = Keys.from_numpy(
        tc, jk.s_coeffs, jk.s_eval, jk.pk[0], jk.pk[1],
        np.asarray(jk.relin.kb), np.asarray(jk.relin.ka),
        rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jk.rot.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("FHE_AFFINE_AUTO", raising=False)
        gather = Evaluator(tc, tk)
        mp.setenv("FHE_AFFINE_AUTO", "force")
        jev, affine = JEvaluator(jc, jk), Evaluator(tc, tk)
    assert jev.use_affine and affine.use_affine and not gather.use_affine
    return jk, jev, gather, affine


MASK = np.arange(RING // 2) / RING

OPS = {
    "rotate": lambda ev, ct: ev.rotate(ct, 2),
    "rotate_neg": lambda ev, ct: ev.rotate(ct, -3),
    "rotate_hoisted": lambda ev, ct: ev.rotate_hoisted(ct, ev.rotate_precompute(ct), 5),
    "mult_plain_roll": lambda ev, ct: ev.mult_plain_at(ct, MASK, roll=3),
    "conjugate": lambda ev, ct: ev.conjugate(ct),
}


@pytest.mark.parametrize("level", [0, 2])
@pytest.mark.parametrize("op", sorted(OPS))
def test_evaluator_affine_matches_gather_and_jax(evs, op, level):
    jk, jev, gather, affine = evs
    x = np.random.default_rng(level).uniform(-1, 1, RING // 2)
    jct = jk.encrypt(x, level=level, seed=1)
    ct = Ciphertext.from_numpy(np.asarray(jct.data), jct.level, jct.sdeg, jct.slots, "cpu")
    want = OPS[op](jev, jct)
    by_gather, by_affine = OPS[op](gather, ct), OPS[op](affine, ct)
    assert (by_affine.level, by_affine.sdeg) == (want.level, want.sdeg)
    np.testing.assert_array_equal(by_affine.data.numpy(), np.asarray(want.data).astype(np.int64))
    assert torch.equal(by_affine.data, by_gather.data)


def test_frozen_galois_affine_miss_raises(evs):
    """A per-g constant first wanted inside a frozen section (a CUDA graph
    capture) raises; a cached one is read and recorded."""
    _, _, _, affine = evs
    ctx = affine.ctx
    g = ctx.galois_element_rot(9)
    with pytest.raises(FrozenError, match="affine automorphism constants"):
        with affine.frozen():
            ctx.galois_affine(g)
    assert g not in ctx._galois_affine_cache and not ctx.frozen
    ctx.galois_affine(g)
    data = torch.zeros(2, ctx.limbs_at(0), RING, dtype=torch.int64)
    with affine.frozen() as reads:
        affine._apply_auto(data, g, 0)
    assert any(r is ctx.galois_affine(g) for r in reads)
    assert any(r is ctx.auto_tables() for r in reads)


def test_frozen_auto_tables_miss_raises():
    ctx = Context(CkksParams(ring_n=256, mult_depth=2), device="cpu")
    ev = Evaluator(ctx, Keys.generate(ctx, seed=0))
    with pytest.raises(FrozenError, match="affine automorphism tables"):
        with ev.frozen():
            ctx.auto_tables()


@pytest.fixture(scope="module")
def staged_env():
    """The JAX staged-sort configuration at N=8 and the port's on its keys."""
    N = 8
    vals = np.random.default_rng(0).permutation(N) / N + 0.5 / N
    cfg = SignConfig(CompositeSignConfig(3, 2, 2))
    depth = measure_direct_sort_depth(N, RING, cfg)["mult_depth"]
    jctx = JContext(JParams(ring_n=RING, mult_depth=depth))
    jkeys = JKeys.generate(jctx, seed=0)
    jkeys.gen_rotation_keys(sorted(scan_rotation_indices(N, RING)))
    jct = jkeys.encrypt(vals, seed=0)
    ctx = Context(CkksParams(ring_n=RING, mult_depth=depth), device="cpu")
    keys = Keys.from_numpy(
        ctx, jkeys.s_coeffs, jkeys.s_eval, jkeys.pk[0], jkeys.pk[1],
        np.asarray(jkeys.relin.kb), np.asarray(jkeys.relin.ka),
        rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jkeys.rot.items()})
    ct = Ciphertext.from_numpy(np.asarray(jct.data), jct.level, jct.sdeg, jct.slots, "cpu")
    by_gather = StagedDirectSort(Evaluator(ctx, keys), N, cfg)(ct)
    return N, vals, cfg, (jctx, jkeys, jct), (keys, ct, by_gather)


def _affine_sort(monkeypatch, staged_env):
    N, vals, cfg, _, (keys, ct, by_gather) = staged_env
    monkeypatch.setenv("FHE_AFFINE_AUTO", "force")
    ev = Evaluator(keys.ctx, keys)
    assert ev.use_affine
    out = StagedDirectSort(ev, N, cfg)(ct)
    assert torch.equal(out.data, by_gather.data)
    assert float(np.abs(keys.decrypt(out, N) - np.sort(vals)).max()) < 0.01
    return out


def test_staged_sort_affine_equals_gather(monkeypatch, staged_env):
    """The staged N=8 sort on the affine path gives the gather path's planes."""
    _affine_sort(monkeypatch, staged_env)


@pytest.mark.slow
def test_staged_sort_affine_matches_jax(monkeypatch, staged_env):
    """The staged N=8 sort with the affine path on in both packages: equal
    output planes (slow: the JAX package compiles each stage with the affine
    path's products, about 100 s)."""
    out = _affine_sort(monkeypatch, staged_env)
    jctx, jkeys, jct = staged_env[3]
    jsrt = JStagedDirectSort(JEvaluator(jctx, jkeys, jit_ops=False), staged_env[0],
                             JSignConfig(JCompositeSignConfig(3, 2, 2)))
    assert jsrt.ev.use_affine
    jout = jsrt.index_check(jsrt.construct_rank(jct), jct)
    assert (out.level, out.sdeg, out.slots) == (jout.level, jout.sdeg, jout.slots)
    np.testing.assert_array_equal(out.data.numpy(), np.asarray(jout.data).astype(np.int64))
