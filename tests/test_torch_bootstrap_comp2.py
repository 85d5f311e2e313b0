"""The port's bootstrapping against the JAX package's on the composite-scaling
chain (comp=2, Delta = 2^56 from prime pairs), ring 256, shared keys:
`_mod_raise` from the bottom prime PAIR by CRT, the whole bootstrap, one
double-angle EvalMod shape and the three arcsine corrections, output limb
planes bit-equal (tolerance 0).  Decrypted values are held to the reference
test's 2e-2."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core.bootstrap import Bootstrapper as JBootstrapper
from fhe_sorting_tpu.core.cipher import Ciphertext as JCiphertext
from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu_torch.core.bootstrap import Bootstrapper
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys

torch.set_num_threads(2)

RING, NH = 256, 128
PARAMS = {
    "plain": dict(ring_n=RING, mult_depth=19, scale_bits=56, comp=2, base_limbs=4,
                  secret_hamming=64),
    "first_mod": dict(ring_n=RING, mult_depth=19, scale_bits=56, comp=2, base_limbs=4,
                      secret_hamming=64, first_mod_bits=30),
}


def _pair(params):
    jctx = JContext(JParams(**params))
    jkeys = JKeys.generate(jctx, seed=0)
    jkeys.gen_conj_key()
    jev = JEvaluator(jctx, jkeys)
    jkeys.gen_rotation_keys(sorted(JBootstrapper(jev, K=13.0, sin_degree=31).required_rotations()))
    ctx = Context(CkksParams(**params), device="cpu")
    keys = Keys.from_numpy(
        ctx, jkeys.s_coeffs, jkeys.s_eval, jkeys.pk[0], jkeys.pk[1],
        np.asarray(jkeys.relin.kb), np.asarray(jkeys.relin.ka),
        rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jkeys.rot.items()})
    return jkeys, jev, keys, Evaluator(ctx, keys)


@pytest.fixture(scope="module")
def env():
    return _pair(PARAMS["plain"])


def _low(env, z, level):
    jkeys, jev, keys, tev = env
    j = jkeys.encrypt(z, seed=1)
    t = Ciphertext.from_numpy(np.asarray(j.data), j.level, j.sdeg, j.slots, "cpu")
    return jev.level_reduce(j, level), tev.level_reduce(t, level)


def _same(to, jo, what):
    assert (to.level, to.sdeg, to.slots) == (jo.level, jo.sdeg, jo.slots), what
    np.testing.assert_array_equal(to.data.numpy(), np.asarray(jo.data).astype(np.int64), what)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_mod_raise_comp2_matches_jax(env, name):
    """CRT of the bottom pair with the t >= q1/2 centring, also where
    `first_mod_bits` enlarges that pair."""
    e = env if name == "plain" else _pair(PARAMS[name])
    jkeys, jev, keys, tev = e
    z = np.random.default_rng(1).uniform(-0.4, 0.4, NH)
    jlow, tlow = _low(e, z, 18)
    jb = JBootstrapper(jev, K=13.0, sin_degree=31)
    tb = Bootstrapper(tev, K=13.0, sin_degree=31)
    p0, p1 = keys.ctx.q_primes[:2]
    assert tb.comp == 2 and tb.q0 == jb.q0 == p0 * p1
    jr = jb._mod_raise(JCiphertext(jlow.data[:, :2, :], jlow.level, 1, NH))
    tr = tb._mod_raise(Ciphertext(tlow.data[:, :2, :], tlow.level, 1, NH))
    assert tr.num_limbs == keys.ctx.num_q and tr.level == 0
    _same(tr, jr, f"_mod_raise comp=2 ({name})")
    # both halves of the centring are exercised
    x = tev._intt(tlow.data[:, :2, :], keys.ctx.limbs_range(0, 2))
    t = torch.remainder(torch.remainder(x[:, 1] - x[:, 0], p1) * pow(p0, -1, p1), p1)
    assert bool((t >= (p1 + 1) // 2).any()) and bool((t < (p1 + 1) // 2).any())


def test_bootstrap_composite_scaling_matches_jax(env):
    jkeys, jev, keys, tev = env
    z = np.random.default_rng(5).uniform(-0.2, 0.2, NH)
    jlow, tlow = _low(env, z, 18)
    out = Bootstrapper(tev, K=13.0, sin_degree=127).bootstrap(tlow)
    _same(out, JBootstrapper(jev, K=13.0, sin_degree=127).bootstrap(jlow), "composite scaling")
    assert out.level < tlow.level
    np.testing.assert_allclose(keys.decrypt(out, NH), z, atol=2e-2)


def test_bootstrap_double_angle_matches_jax(env):
    """The uniform-secret EvalMod shape: a cos seed, two double-angle steps,
    the arcsine series in y."""
    jkeys, jev, keys, tev = env
    z = np.random.default_rng(6).uniform(-0.2, 0.2, NH)
    jlow, tlow = _low(env, z, 18)
    shape = dict(K=13.0, sin_degree=40, double_angle=2, asin_terms=1)
    jb, tb = JBootstrapper(jev, **shape), Bootstrapper(tev, **shape)
    np.testing.assert_array_equal(tb.sin_coeffs, jb.sin_coeffs)
    out = tb.bootstrap(tlow)
    _same(out, jb.bootstrap(jlow), "double angle")
    assert out.level < tlow.level
    np.testing.assert_allclose(keys.decrypt(out, NH), z, atol=2e-2)


@pytest.mark.parametrize("double_angle,asin_terms",
                         [(0, 0), (0, 1), (0, 2), (0, 3), (2, 0), (2, 2), (2, 3)])
def test_eval_mod_shapes_match_jax(env, double_angle, asin_terms):
    """`_eval_mod` alone on a fresh ciphertext, every branch."""
    jkeys, jev, keys, tev = env
    v = np.random.default_rng(8).uniform(-0.05, 0.05, NH)
    j = jkeys.encrypt(v, seed=2)
    t = Ciphertext.from_numpy(np.asarray(j.data), j.level, j.sdeg, j.slots, "cpu")
    shape = dict(K=2.0, sin_degree=15, double_angle=double_angle, asin_terms=asin_terms)
    jb, tb = JBootstrapper(jev, **shape), Bootstrapper(tev, **shape)
    out = tb._eval_mod(t)
    _same(out, jb._eval_mod(j), f"_eval_mod {shape}")
    want = np.sin(2 * np.pi * 2.0 * v) / (2 * np.pi)
    if asin_terms or double_angle:
        want = np.arcsin(2 * np.pi * want) / (2 * np.pi)
    tol = 2e-3 if asin_terms >= 2 or (asin_terms == 0 and double_angle == 0) else 2e-2
    np.testing.assert_allclose(keys.decrypt(out, NH), want, atol=tol)
