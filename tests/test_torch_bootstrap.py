"""The port's bootstrapping against the JAX package's on the single-prime
chain (comp=1), ring 256, shared keys: `_mod_raise` and the whole
`Bootstrapper.bootstrap` for level budgets (1,1) and (2,2) and for sparse
packing (slots=16), output limb planes bit-equal (tolerance 0).  Decrypted
values are held to the reference test's 2e-2.  One JAX evaluator serves the
file, so its per-level compiles are shared."""

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
PARAMS = dict(ring_n=RING, mult_depth=24, secret_hamming=64)
SHAPE = dict(K=13.0, sin_degree=127)


@pytest.fixture(scope="module")
def env():
    jctx = JContext(JParams(**PARAMS))
    jkeys = JKeys.generate(jctx, seed=0)
    jkeys.gen_conj_key()
    jev = JEvaluator(jctx, jkeys)
    steps = set()
    for budget in ((1, 1), (2, 2)):
        steps |= JBootstrapper(jev, level_budget=budget, **SHAPE).required_rotations()
    jkeys.gen_rotation_keys(sorted(steps))
    ctx = Context(CkksParams(**PARAMS), device="cpu")
    keys = Keys.from_numpy(
        ctx, jkeys.s_coeffs, jkeys.s_eval, jkeys.pk[0], jkeys.pk[1],
        np.asarray(jkeys.relin.kb), np.asarray(jkeys.relin.ka),
        rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jkeys.rot.items()})
    return jkeys, jev, keys, Evaluator(ctx, keys)


def _low(env, z, slots=None):
    """The same ciphertext in both packages, reduced to the last level but one."""
    jkeys, jev, keys, tev = env
    j = jkeys.encrypt(z, slots=slots, seed=1)
    t = Ciphertext.from_numpy(np.asarray(j.data), j.level, j.sdeg, j.slots, "cpu")
    lvl = PARAMS["mult_depth"] - 1
    return jev.level_reduce(j, lvl), tev.level_reduce(t, lvl)


def _same(to, jo, what):
    assert (to.level, to.sdeg, to.slots) == (jo.level, jo.sdeg, jo.slots), what
    np.testing.assert_array_equal(to.data.numpy(), np.asarray(jo.data).astype(np.int64), what)


def test_mod_raise_matches_jax(env):
    jkeys, jev, keys, tev = env
    z = np.random.default_rng(1).uniform(-0.4, 0.4, NH)
    jlow, tlow = _low(env, z)
    _same(tlow, jlow, "level_reduce")
    jb, tb = JBootstrapper(jev, **SHAPE), Bootstrapper(tev, **SHAPE)
    assert tb.q0 == jb.q0 == keys.ctx.q_primes[0] and tb.comp == 1
    jr = jb._mod_raise(JCiphertext(jlow.data[:, :1, :], jlow.level, 1, NH))
    tr = tb._mod_raise(Ciphertext(tlow.data[:, :1, :], tlow.level, 1, NH))
    assert tr.num_limbs == keys.ctx.num_q and tr.level == 0
    _same(tr, jr, "_mod_raise comp=1")


@pytest.mark.parametrize("budget", [(1, 1), (2, 2)])
def test_bootstrap_matches_jax(env, budget):
    jkeys, jev, keys, tev = env
    z = np.random.default_rng(3).uniform(-0.2, 0.2, NH)
    jlow, tlow = _low(env, z)
    jb = JBootstrapper(jev, level_budget=budget, **SHAPE)
    tb = Bootstrapper(tev, level_budget=budget, **SHAPE)
    assert tb.required_rotations() == jb.required_rotations()
    np.testing.assert_array_equal(tb.sin_coeffs, jb.sin_coeffs)
    out = tb.bootstrap(tlow)
    _same(out, jb.bootstrap(jlow), f"bootstrap {budget}")
    assert out.level < tlow.level
    np.testing.assert_allclose(keys.decrypt(out, NH), z, atol=2e-2)
    # the scaled SlotsToCoeffs chain is cached per input scale
    assert len(tb._s2c_cache) == 1
    tb.bootstrap(tlow)
    assert len(tb._s2c_cache) == 1


def test_bootstrap_sparse_packing_matches_jax(env):
    """slots=16 rides the full-packing pipeline; the slot count is restored."""
    jkeys, jev, keys, tev = env
    z = np.random.default_rng(7).uniform(-0.2, 0.2, 16)
    jlow, tlow = _low(env, z, slots=16)
    out = Bootstrapper(tev, **SHAPE).bootstrap(tlow)
    _same(out, JBootstrapper(jev, **SHAPE).bootstrap(jlow), "sparse packing")
    assert out.slots == 16 and out.level < tlow.level
    np.testing.assert_allclose(keys.decrypt(out, 16), z, atol=2e-2)


def test_bootstrap_msg_scale_down_matches_jax(env):
    """The pre-scale of larger messages and its inverse at the end."""
    jkeys, jev, keys, tev = env
    z = np.random.default_rng(9).uniform(-0.4, 0.4, NH)
    lvl = PARAMS["mult_depth"] - 2
    j = jkeys.encrypt(z, seed=1)
    t = Ciphertext.from_numpy(np.asarray(j.data), j.level, j.sdeg, j.slots, "cpu")
    jlow, tlow = jev.level_reduce(j, lvl), tev.level_reduce(t, lvl)
    out = Bootstrapper(tev, **SHAPE).bootstrap(tlow, msg_scale_down=2.0)
    _same(out, JBootstrapper(jev, **SHAPE).bootstrap(jlow, msg_scale_down=2.0), "scale down")
    np.testing.assert_allclose(keys.decrypt(out, NH), z, atol=2e-2)
