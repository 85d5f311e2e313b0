"""The port's BitonicSort against the JAX package's on shared keys: N=2 (one
comparator stage) without a bootstrap, and N=4 on a shallow chain where a
real bootstrap fires mid-network.  Output limb planes bit-equal (tolerance 0); decrypted sorts
within 0.01 of `np.sort`, the reference tests' bound."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core.bootstrap import Bootstrapper as JBootstrapper
from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu.models import bitonic as jbit
from fhe_sorting_tpu.ops import sign as jsign
from fhe_sorting_tpu_torch.core.bootstrap import Bootstrapper
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.models import bitonic as tbit
from fhe_sorting_tpu_torch.ops import sign as tsign

torch.set_num_threads(2)

POW2 = sorted({1 << i for i in range(6)} | {-(1 << i) for i in range(6)})


def _pair(params, steps, boot_shape=None):
    jctx = JContext(JParams(**params))
    jkeys = JKeys.generate(jctx, seed=0)
    jev = JEvaluator(jctx, jkeys)
    if boot_shape is not None:
        jkeys.gen_conj_key()
        steps = sorted(set(steps) | JBootstrapper(jev, **boot_shape).required_rotations())
    jkeys.gen_rotation_keys(steps)
    ctx = Context(CkksParams(**params), device="cpu")
    keys = Keys.from_numpy(
        ctx, jkeys.s_coeffs, jkeys.s_eval, jkeys.pk[0], jkeys.pk[1],
        np.asarray(jkeys.relin.kb), np.asarray(jkeys.relin.ka),
        rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jkeys.rot.items()})
    return jkeys, jev, keys, Evaluator(ctx, keys)


def _cts(jkeys, x, n):
    j = jkeys.encrypt(x, slots=n, seed=1)
    return j, Ciphertext.from_numpy(np.asarray(j.data), j.level, j.sdeg, j.slots, "cpu")


def _same(to, jo, what):
    assert (to.level, to.sdeg, to.slots) == (jo.level, jo.sdeg, jo.slots), what
    np.testing.assert_array_equal(to.data.numpy(), np.asarray(jo.data).astype(np.int64), what)


def _cfgs(n, dg, df):
    return (jsign.SignConfig(jsign.CompositeSignConfig(n, dg, df)),
            tsign.SignConfig(tsign.CompositeSignConfig(n, dg, df)))


@pytest.fixture(scope="module")
def env():
    return _pair(dict(ring_n=512, mult_depth=18), POW2)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 2048])
def test_rotation_indices_match_jax(n):
    assert tbit.rotation_indices_bitonic(n) == jbit.rotation_indices_bitonic(n)


@pytest.mark.parametrize("N,x", [(2, [0.8, 0.3]), (2, [0.25, 0.625])])
def test_bitonic_sort_matches_jax(env, N, x):
    jkeys, jev, keys, tev = env
    x = np.array(x)
    jct, ct = _cts(jkeys, x, N)
    jcfg, tcfg = _cfgs(3, 2, 2)
    out = tbit.BitonicSort(tev, N, normalize=1.0).sort(ct, tsign.SignFunc.CompositeSign, tcfg)
    jout = jbit.BitonicSort(jev, N, normalize=1.0).sort(jct, jsign.SignFunc.CompositeSign, jcfg)
    _same(out, jout, f"BitonicSort N={N}")
    assert np.abs(keys.decrypt(out, N) - np.sort(x)).max() < 0.01


def test_bitonic_normalize_matches_jax(env):
    """A 1/4 normalisation in and out."""
    jkeys, jev, keys, tev = env
    x = np.array([3.2, 1.2])
    jct, ct = _cts(jkeys, x, 2)
    jcfg, tcfg = _cfgs(3, 2, 2)
    out = tbit.BitonicSort(tev, 2, normalize=4.0).sort(ct, tsign.SignFunc.CompositeSign, tcfg)
    _same(out, jbit.BitonicSort(jev, 2, normalize=4.0).sort(
        jct, jsign.SignFunc.CompositeSign, jcfg), "normalize")
    assert tbit.BitonicSort(tev, 2).normalize == jbit.BitonicSort(jev, 2).normalize == 255.0
    assert np.abs(keys.decrypt(tev.rescale(out), 2) - np.sort(x)).max() < 0.01 * 4


def test_bitonic_sort_with_bootstrap_matches_jax():
    """A shallow chain forces at least one refresh mid-network (the reference
    test's shape: ring 256, depth 25, sparse secret)."""
    shape = dict(K=13.0, sin_degree=127)
    jkeys, jev, keys, tev = _pair(dict(ring_n=256, mult_depth=25, secret_hamming=64),
                                  POW2, boot_shape=shape)
    jbs, tbs = JBootstrapper(jev, **shape), Bootstrapper(tev, **shape)
    jboots, tboots = [], []

    def jfn(ct):
        jboots.append(ct.level)
        return jbs.bootstrap(ct, msg_scale_down=2.0)

    def tfn(ct):
        tboots.append(ct.level)
        return tbs.bootstrap(ct, msg_scale_down=2.0)

    N = 4
    x = np.array([0.19, 0.06, 0.13, 0.02])
    jct, ct = _cts(jkeys, x, N)
    jcfg, tcfg = _cfgs(3, 2, 1)
    out = tbit.BitonicSort(tev, N, normalize=1.0, bootstrap_fn=tfn,
                           bootstrap_level=12).sort(ct, tsign.SignFunc.CompositeSign, tcfg)
    jout = jbit.BitonicSort(jev, N, normalize=1.0, bootstrap_fn=jfn,
                            bootstrap_level=12).sort(jct, jsign.SignFunc.CompositeSign, jcfg)
    assert len(tboots) >= 1 and tboots == jboots, "bootstrap never fired"
    _same(out, jout, "BitonicSort with bootstrap")
    assert np.abs(keys.decrypt(out, N) - np.sort(x)).max() < 0.01
