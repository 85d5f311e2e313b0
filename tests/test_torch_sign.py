"""The port's sign, comparison and Chebyshev-function layer against the JAX
package.

Both run on the same ciphertext with the same keys (the JAX package's,
converted through numpy), so every output limb plane must be equal
(tolerance 0); decrypted values are also held against the plain function
they approximate, with the tolerance stated at each check.  The JAX
evaluator runs with its per-op jit and is shared by the whole file: every
test walks the same levels, so the compiles are paid once."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu.ops import chebyshev as jcheb
from fhe_sorting_tpu.ops import compare as jcmp
from fhe_sorting_tpu.ops import sign as jsign
from fhe_sorting_tpu.utils import sinc_coeffs as jsinc
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.ops import chebyshev as tcheb
from fhe_sorting_tpu_torch.ops import compare as tcmp
from fhe_sorting_tpu_torch.ops import sign as tsign
from fhe_sorting_tpu_torch.utils import sinc_coeffs as tsinc

torch.set_num_threads(2)

RING, DEPTH, SLOTS = 256, 14, 128


@pytest.fixture(scope="module")
def pair():
    params = dict(ring_n=RING, mult_depth=DEPTH)
    jc = JContext(JParams(**params))
    jk = JKeys.generate(jc, seed=0)
    tc = Context(CkksParams(**params), device="cpu")
    tk = Keys.from_numpy(tc, jk.s_coeffs, jk.s_eval, jk.pk[0], jk.pk[1],
                         np.asarray(jk.relin.kb), np.asarray(jk.relin.ka))
    return jk, JEvaluator(jc, jk), tk, Evaluator(tc, tk)


def _cts(jk, x, seed=1):
    j = jk.encrypt(x, seed=seed)
    return j, Ciphertext.from_numpy(np.asarray(j.data), j.level, j.sdeg, j.slots, "cpu")


def _same(to, jo, what):
    assert (to.level, to.sdeg, to.slots) == (jo.level, jo.sdeg, jo.slots), what
    np.testing.assert_array_equal(to.data.numpy(), np.asarray(jo.data).astype(np.int64), what)


def _gapped(seed=0):
    """Values in [-1, 1] at least 0.2 from zero."""
    rng = np.random.default_rng(seed)
    return rng.choice([-1.0, 1.0], SLOTS) * rng.uniform(0.2, 1.0, SLOTS)


def test_constants_match_jax():
    for name in ("G3", "F3", "F3_FINAL", "G4_CHEB", "F4"):
        assert getattr(tsign, name) == getattr(jsign, name), name
    assert [f.name for f in tsign.SignFunc] == [f.name for f in jsign.SignFunc]
    assert tsign.SignConfig().mult_depth == jsign.SignConfig().mult_depth == 100
    np.testing.assert_array_equal(tsign.signum_polycircuit_coeffs(63),
                                  jsign.signum_polycircuit_coeffs(63))
    assert tsinc.sinc_coefficients(4, stretch=2.0) == jsinc.sinc_coefficients(4, stretch=2.0)


@pytest.mark.parametrize("n,dg,df,final_scale", [(3, 2, 2, 1.0), (3, 1, 1, 0.5), (3, 0, 0, 0.5),
                                                 (4, 1, 1, 0.5)])
def test_composite_sign_matches_jax(pair, n, dg, df, final_scale):
    jk, jev, tk, tev = pair
    x = _gapped(n)
    ja, ta = _cts(jk, x)
    jo = jsign.composite_sign(jev, ja, jsign.SignConfig(jsign.CompositeSignConfig(n, dg, df)),
                              final_scale=final_scale)
    to = tsign.composite_sign(tev, ta, tsign.SignConfig(tsign.CompositeSignConfig(n, dg, df)),
                              final_scale=final_scale)
    _same(to, jo, f"composite_sign n={n} dg={dg} df={df}")
    if (dg, df) == (2, 2):
        # four iterations resolve a 0.2 gap to ~1e-3
        np.testing.assert_allclose(tk.decrypt(to), np.sign(x), atol=5e-3)


def test_bootstrap_fn_is_passed_through(pair):
    """With a real depth in the config the loop refreshes through the
    caller's function exactly where the JAX package does."""
    jk, jev, tk, tev = pair
    ja, ta = _cts(jk, _gapped(9))
    calls = {"j": [], "t": []}

    def boot(which):
        def fn(ct):
            calls[which].append(ct.level)
            return ct
        return fn

    jo = jsign.composite_sign(jev, ja, jsign.SignConfig(jsign.CompositeSignConfig(3, 1, 2), 8),
                              bootstrap_fn=boot("j"))
    to = tsign.composite_sign(tev, ta, tsign.SignConfig(tsign.CompositeSignConfig(3, 1, 2), 8),
                              bootstrap_fn=boot("t"))
    _same(to, jo, "composite_sign with bootstrap_fn")
    assert calls["t"] == calls["j"] and calls["t"]


def test_sign_adv_and_odd_poly15_match_jax(pair):
    jk, jev, tk, tev = pair
    x = _gapped(5)
    ja, ta = _cts(jk, x)
    jo, to = jsign.sign_adv(jev, ja, 2, 2), tsign.sign_adv(tev, ta, 2, 2)
    _same(to, jo, "sign_adv")
    np.testing.assert_allclose(tk.decrypt(to), (x > 0).astype(float), atol=5e-3)
    _same(tsign.eval_odd_poly15(tev, ta, tsign.F4), jsign.eval_odd_poly15(jev, ja, jsign.F4),
          "eval_odd_poly15")


@pytest.mark.parametrize("func", ["CompositeSign", "NaiveDiscrete"])
def test_sign_dispatcher_matches_jax(pair, func):
    jk, jev, tk, tev = pair
    ja, ta = _cts(jk, _gapped(6))
    jcfg = jsign.SignConfig(jsign.CompositeSignConfig(3, 1, 1))
    tcfg = tsign.SignConfig(tsign.CompositeSignConfig(3, 1, 1))
    jo = jsign.sign(jev, ja, jsign.SignFunc[func], jcfg, final_scale=0.5)
    to = tsign.sign(tev, ta, tsign.SignFunc[func], tcfg, final_scale=0.5)
    _same(to, jo, f"sign {func}")


def test_eval_chebyshev_function_matches_jax(pair):
    jk, jev, tk, tev = pair
    x = np.random.default_rng(2).uniform(-1, 1, SLOTS)
    ja, ta = _cts(jk, x)
    jo = jcheb.eval_chebyshev_function(jev, np.tanh, ja, 15)
    to = tcheb.eval_chebyshev_function(tev, np.tanh, ta, 15)
    _same(to, jo, "eval_chebyshev_function")
    np.testing.assert_allclose(tk.decrypt(to), np.tanh(x), atol=1e-3)   # fit + 2^28-scale noise


@pytest.mark.parametrize("post_scale", [0.5, 0.25])
def test_compare_matches_jax(pair, post_scale):
    jk, jev, tk, tev = pair
    rng = np.random.default_rng(7)
    a = rng.uniform(0, 1, SLOTS)
    b = np.where(rng.random(SLOTS) < 0.5, a + 0.25, a - 0.25) * 0.8
    a = a * 0.8
    ja, ta = _cts(jk, a, seed=1)
    jb, tb = _cts(jk, b, seed=2)
    jcfg = jsign.SignConfig(jsign.CompositeSignConfig(3, 2, 2))
    tcfg = tsign.SignConfig(tsign.CompositeSignConfig(3, 2, 2))
    jo = jcmp.Comparison(jev).compare(ja, jb, jsign.SignFunc.CompositeSign, jcfg,
                                      post_scale=post_scale)
    to = tcmp.Comparison(tev).compare(ta, tb, tsign.SignFunc.CompositeSign, tcfg,
                                      post_scale=post_scale)
    _same(to, jo, "compare")
    np.testing.assert_allclose(tk.decrypt(to), (a > b) * 2 * post_scale, atol=5e-3)


def test_indicators_match_jax(pair):
    jk, jev, tk, tev = pair
    x = np.random.default_rng(8).choice([-0.7, -0.45, 0.0, 0.1, 0.5, 0.7], SLOTS)
    ja, ta = _cts(jk, x)
    jcfg = jsign.SignConfig(jsign.CompositeSignConfig(3, 2, 2))
    tcfg = tsign.SignConfig(tsign.CompositeSignConfig(3, 2, 2))
    jo = jcmp.Comparison(jev).indicator(ja, 0.25, jsign.SignFunc.CompositeSign, jcfg)
    to = tcmp.Comparison(tev).indicator(ta, 0.25, tsign.SignFunc.CompositeSign, tcfg)
    _same(to, jo, "indicator")
    np.testing.assert_allclose(tk.decrypt(to), (np.abs(x) < 0.25).astype(float), atol=1e-2)
    jo = jcmp.Comparison(jev).indicator_adv(ja, 1.0, 2, 2)
    to = tcmp.Comparison(tev).indicator_adv(ta, 1.0, 2, 2)
    _same(to, jo, "indicator_adv")
