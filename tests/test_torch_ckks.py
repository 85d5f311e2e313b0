"""The PyTorch port's CKKS context, keys and evaluator against the JAX package.

Tables, keys (secret, public key) and ciphertexts are compared bit for bit.
Evaluator ops run on identical inputs: the JAX package's keys and
ciphertexts, converted with `Keys.from_numpy` / `Ciphertext.from_numpy`, so
every output limb plane must be equal (tolerance 0).  Decryption of equal
ciphertexts must give equal values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys

torch.set_num_threads(2)

PARAMS = {
    "comp1": dict(ring_n=1024, mult_depth=4),
    "comp2": dict(ring_n=1024, mult_depth=3, scale_bits=56, comp=2, base_limbs=4),
}


def _digits(d):
    d = np.asarray(d).astype(np.int64)
    return sum(d[a] << (8 * a) for a in range(4))


def _eq(t, j, what=""):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j).astype(np.int64), what)


@pytest.mark.parametrize("impl", ["butterfly", "mxu"])
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_context_tables_match_jax(name, impl):
    jc = JContext(JParams(**PARAMS[name], ntt_impl=impl))
    tc = Context(CkksParams(**PARAMS[name], ntt_impl=impl), device="cpu")
    assert tc.ntt_impl == jc.ntt_impl == impl
    assert tc.q_primes == jc.q_primes and tc.sp_primes == jc.sp_primes
    assert tc._scales_dec == jc._scales_dec
    _eq(tc.pc.p, jc.pc.p)
    if impl == "butterfly":
        for f in ("p", "n_inv", "psi_rev", "ipsi_rev"):
            _eq(getattr(tc.tables, f), getattr(jc.tables, f), f)
    else:
        _eq(tc.tables.p, jc.tables.p)
        for f in ("w1f", "w2f", "w2i", "w1i"):
            _eq(getattr(tc.tables, f), _digits(getattr(jc.tables, f)), f)
        for f in ("tf", "tf_sh", "ti", "ti_sh"):
            _eq(getattr(tc.tables, f), getattr(jc.tables, f), f)
    for tp, jp in zip(tc.rescale_plans, jc.rescale_plans, strict=True):
        _eq(tp.qlast_mod_qi, jp.qlast_mod_qi)
        _eq(tp.qlast_inv, jp.qlast_inv)
        assert tp.qlast_half == int(jp.qlast_half)
    for level, (tp, jp) in enumerate(zip(tc.ks_plans, jc.ks_plans, strict=True)):
        _eq(tp.dhat_inv, jp.dhat_inv)
        for j, (lo, hi) in enumerate(tc.digit_layout(level)):
            ext = _digits(jp.dig_ext_dT[j])          # [T, alpha], zero-padded
            _eq(tp.dig_ext[j], ext[:, : hi - lo])
            assert not ext[:, hi - lo:].any()
        _eq(tp.phat_inv, jp.phat_inv)
        _eq(tp.pext, _digits(jp.pext_dT))
        _eq(tp.p_inv_mod_qi, jp.p_inv_mod_qi)
    np.testing.assert_array_equal(tc._root_exp, jc._root_exp)
    for g in (5, 25, 2047):
        _eq(tc.galois_perm(g), jc.galois_perm(g))


@pytest.fixture(scope="module")
def pair():
    """JAX context/keys/evaluator and the port's, on the same keys."""
    params = PARAMS["comp1"]
    jc = JContext(JParams(**params))
    jk = JKeys.generate(jc, seed=0)
    jk.gen_rotation_keys([1, 3])
    tc = Context(CkksParams(**params), device="cpu")
    tk = Keys.from_numpy(
        tc, jk.s_coeffs, jk.s_eval, jk.pk[0], jk.pk[1],
        np.asarray(jk.relin.kb), np.asarray(jk.relin.ka),
        rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jk.rot.items()})
    return jk, JEvaluator(jc, jk), tk, Evaluator(tc, tk)


def test_keys_and_encrypt_match_jax():
    params = PARAMS["comp2"]
    jk = JKeys.generate(JContext(JParams(**params)), seed=3)
    tk = Keys.generate(Context(CkksParams(**params), device="cpu"), seed=3)
    np.testing.assert_array_equal(tk.s_coeffs, jk.s_coeffs)
    np.testing.assert_array_equal(tk.s_eval, jk.s_eval)
    np.testing.assert_array_equal(tk.pk[0], jk.pk[0])
    np.testing.assert_array_equal(tk.pk[1], jk.pk[1])
    x = np.random.default_rng(1).uniform(-1, 1, 64)
    for level in (0, 1):
        jct, tct = jk.encrypt(x, level=level, seed=5), tk.encrypt(x, level=level, seed=5)
        assert (tct.level, tct.sdeg, tct.slots) == (jct.level, jct.sdeg, jct.slots)
        _eq(tct.data, jct.data)
        np.testing.assert_array_equal(tk.decrypt(tct), jk.decrypt(jct))


@pytest.mark.parametrize("impl", ["butterfly", "mxu"])
def test_generated_keys_decrypt(impl):
    """The port's own key-switch keys (device generator) relinearize and
    rotate correctly."""
    ctx = Context(CkksParams(**PARAMS["comp2"], ntt_impl=impl), device="cpu")
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys([2])
    ev = Evaluator(ctx, keys)
    x = np.random.default_rng(2).uniform(-1, 1, 512)
    out = ev.rotate(ev.rescale(ev.square(keys.encrypt(x, seed=1))), 2)
    np.testing.assert_allclose(keys.decrypt(out), np.roll(x * x, -2), atol=1e-6)


MASK = np.linspace(-1, 1, 512)

OPS = {
    "add": lambda ev, a, b: ev.add(a, b),
    "add_scalar": lambda ev, a, b: ev.add(a, 0.25),
    "sub": lambda ev, a, b: ev.sub(a, b),
    "rsub_scalar": lambda ev, a, b: ev.rsub(0.5, a),
    "mult": lambda ev, a, b: ev.mult(a, b),
    "mult_scalar": lambda ev, a, b: ev.mult(a, -0.375),
    "square": lambda ev, a, b: ev.square(a),
    "rescale": lambda ev, a, b: ev.rescale(a if a.sdeg == 2 else ev.mult(a, b)),
    "rotate": lambda ev, a, b: ev.rotate(a, 3),
    "mult_plain": lambda ev, a, b: ev.mult_plain_at(a, MASK),
    "mult_plain_roll": lambda ev, a, b: ev.mult_plain_at(a, MASK, roll=5),
    "level_reduce": lambda ev, a, b: ev.level_reduce(a, a.level + 1),
    "combo": lambda ev, a, b: ev.combo([a, b], [[0.5, -0.25], [0.125, 1.0]], [0.1, 0.0]),
    "negate": lambda ev, a, b: ev.negate(a),
    "add_many": lambda ev, a, b: ev.add_many([a, b, a]),
    "align_group": lambda ev, a, b: ev.align_group([a, ev.rescale(ev.mult(b, b))]),
    "zeros_like": lambda ev, a, b: ev.add(ev.zeros_like(a), b),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_evaluator_op_matches_jax(pair, op):
    jk, jev, tk, tev = pair
    rng = np.random.default_rng(11)
    x, y = rng.uniform(-1, 1, 512), rng.uniform(-1, 1, 512)
    # two input states: (level 0, sdeg 1) and (level 1, sdeg 2)
    for level, sdeg in ((0, 1), (1, 2)):
        ja, jb = jk.encrypt(x, level=level, seed=1), jk.encrypt(y, level=level, seed=2)
        if sdeg == 2:
            ja, jb = jev.mult(ja, 0.5), jev.mult(jb, 0.75)
        ta, tb = (Ciphertext.from_numpy(np.asarray(c.data), c.level, c.sdeg, c.slots, "cpu")
                  for c in (ja, jb))
        jouts, touts = OPS[op](jev, ja, jb), OPS[op](tev, ta, tb)
        if not isinstance(jouts, list):
            jouts, touts = [jouts], [touts]
        for jo, to in zip(jouts, touts, strict=True):
            assert (to.level, to.sdeg, to.slots) == (jo.level, jo.sdeg, jo.slots)
            _eq(to.data, jo.data, f"{op} at level {level}, sdeg {sdeg}")
            np.testing.assert_array_equal(tk.decrypt(to), jk.decrypt(jo))
