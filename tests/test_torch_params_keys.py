"""The port's extended parameters and keys against the JAX package: the
`first_mod_bits` prime chain, the sparse ternary secret, the secret-free key
set of the server, the completed parameter registry and
`eval_chebyshev_function_ab`'s fit.

Everything integer is compared bit for bit (tolerance 0)."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu.utils import params_registry as jreg
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys, SecretKeyMissing
from fhe_sorting_tpu_torch.utils import params_registry as treg

torch.set_num_threads(2)

PARAMS = {
    "comp1": dict(ring_n=512, mult_depth=4, first_mod_bits=30),
    "comp2": dict(ring_n=512, mult_depth=3, scale_bits=56, comp=2, base_limbs=4,
                  first_mod_bits=30),
}


def _eq(t, j, what=""):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j).astype(np.int64), what)


def test_params_fields_and_defaults_match_jax():
    import dataclasses

    tf = [(f.name, f.default) for f in dataclasses.fields(CkksParams)]
    jf = [(f.name, f.default) for f in dataclasses.fields(JParams)]
    assert tf == jf


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_first_mod_bits_context_matches_jax(name):
    jc = JContext(JParams(**PARAMS[name], ntt_impl="butterfly"))
    tc = Context(CkksParams(**PARAMS[name], ntt_impl="butterfly"), device="cpu")
    comp = PARAMS[name].get("comp", 1)
    assert all(2**29 < p < 2**30 for p in tc.q_primes[:comp])    # the enlarged bottom
    plain = Context(CkksParams(**{**PARAMS[name], "first_mod_bits": None},
                               ntt_impl="butterfly"), device="cpu")
    assert plain.q_primes[:comp] != tc.q_primes[:comp]
    assert tc.q_primes == jc.q_primes and tc.sp_primes == jc.sp_primes
    assert tc._scales_dec == jc._scales_dec
    _eq(tc.pc.p, jc.pc.p)
    for f in ("p", "n_inv", "psi_rev", "ipsi_rev"):
        _eq(getattr(tc.tables, f), getattr(jc.tables, f), f)
    for tp, jp in zip(tc.rescale_plans, jc.rescale_plans, strict=True):
        _eq(tp.qlast_mod_qi, jp.qlast_mod_qi)
        _eq(tp.qlast_inv, jp.qlast_inv)
        assert tp.qlast_half == int(jp.qlast_half)
    for tp, jp in zip(tc.ks_plans, jc.ks_plans, strict=True):
        _eq(tp.dhat_inv, jp.dhat_inv)
        _eq(tp.phat_inv, jp.phat_inv)
        _eq(tp.p_inv_mod_qi, jp.p_inv_mod_qi)
    np.testing.assert_array_equal(tc._root_exp, jc._root_exp)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_sparse_secret_keys_match_jax(name):
    params = dict(PARAMS[name], secret_hamming=64)
    jk = JKeys.generate(JContext(JParams(**params)), seed=5)
    tk = Keys.generate(Context(CkksParams(**params), device="cpu"), seed=5)
    assert int(np.count_nonzero(tk.s_coeffs)) == 64
    np.testing.assert_array_equal(tk.s_coeffs, jk.s_coeffs)
    np.testing.assert_array_equal(tk.s_eval, jk.s_eval)
    np.testing.assert_array_equal(tk.pk[0], jk.pk[0])
    np.testing.assert_array_equal(tk.pk[1], jk.pk[1])
    x = np.random.default_rng(1).uniform(-1, 1, 64)
    jct, tct = jk.encrypt(x, seed=5), tk.encrypt(x, seed=5)
    _eq(tct.data, jct.data)
    np.testing.assert_array_equal(tk.decrypt(tct), jk.decrypt(jct))


@pytest.fixture(scope="module")
def secret_free():
    ctx = Context(CkksParams(ring_n=256, mult_depth=3), device="cpu")
    full = Keys.generate(ctx, seed=0)
    full.gen_rotation_keys([1])
    server = Keys.from_numpy(
        ctx, None, None, full.pk[0], full.pk[1],
        full.relin.kb.numpy(), full.relin.ka.numpy(),
        rot={g: (k.kb.numpy(), k.ka.numpy()) for g, k in full.rot.items()})
    return full, server


def test_secret_free_keys_encrypt_and_evaluate(secret_free):
    full, server = secret_free
    assert server.s_eval is None and server.s_coeffs is None
    x = np.arange(8) / 8.0
    ev = Evaluator(server.ctx, server)
    out = ev.rescale(ev.square(ev.rotate(server.encrypt(x, seed=2), 1)))
    np.testing.assert_allclose(full.decrypt(out), np.roll(x, -1) ** 2, atol=1e-4)
    server.gen_rotation_keys([1])          # already present: nothing to generate


@pytest.mark.parametrize("what", ["decrypt", "decrypt_complex", "gen_rotation_keys",
                                  "gen_conj_key", "gen_relin_key"])
def test_secret_free_keys_raise(secret_free, what):
    full, server = secret_free
    ct = full.encrypt(np.arange(8) / 8.0, seed=2)
    calls = {
        "decrypt": lambda: server.decrypt(ct),
        "decrypt_complex": lambda: server.decrypt_complex(ct),
        "gen_rotation_keys": lambda: server.gen_rotation_keys([2]),
        "gen_conj_key": lambda: server.gen_conj_key(),
        "gen_relin_key": lambda: server.gen_relin_key(),
    }
    with pytest.raises(SecretKeyMissing, match="secret key"):
        calls[what]()


def test_secret_needs_both_parts():
    ctx = Context(CkksParams(ring_n=256, mult_depth=2), device="cpu")
    full = Keys.generate(ctx, seed=0)
    with pytest.raises(AssertionError):
        Keys.from_numpy(ctx, full.s_coeffs, None, full.pk[0], full.pk[1],
                        full.relin.kb.numpy(), full.relin.ka.numpy())


REGISTRY_TABLES = ["DIRECT_SORT_DEPTH", "DIRECT_SORT_HYBRID_DEPTH", "MEHP24_DEPTH",
                   "KWAY_CONFIG", "KWAY_MULT_DEPTH", "SERVING_SIGN"]


@pytest.mark.parametrize("name", REGISTRY_TABLES)
def test_registry_table_matches_jax(name):
    assert getattr(treg, name) == getattr(jreg, name)


def test_registry_functions_match_jax():
    for n in (2, 4, 16, 17, 128, 129, 512, 513, 1024, 2048):
        assert treg.direct_sort_sign_cfg(n) == jreg.direct_sort_sign_cfg(n)
        assert treg.mehp24_indicator_cfg(n) == jreg.mehp24_indicator_cfg(n)
    assert (treg.measured_direct_sort_depth(8, 512) == jreg.measured_direct_sort_depth(8, 512))
    public = lambda m: {k for k in vars(m) if not k.startswith("_") and k != "annotations"}
    assert public(treg) == public(jreg)


@pytest.mark.parametrize("env,impl,want", [
    ("butterfly", "auto", "butterfly"), ("mxu", "auto", "mxu"), ("mxu", "butterfly", "butterfly"),
    ("butterfly", "mxu", "mxu"), (None, "mxu", "mxu"), (None, "auto", "butterfly"),
])
def test_fhe_ntt_picks_the_implementation(monkeypatch, env, impl, want):
    """`FHE_NTT`, where set, takes the place of `ntt_impl="auto"`, as in the
    JAX package; "auto" is the butterfly on the CPU in both.  A pinned
    `ntt_impl` wins over the variable (the JAX package lets the variable
    override it, so those cases are not compared with it)."""
    if env is None:
        monkeypatch.delenv("FHE_NTT", raising=False)
    else:
        monkeypatch.setenv("FHE_NTT", env)
    params = dict(ring_n=1 << 15, mult_depth=2, ntt_impl=impl)
    ctx = Context(CkksParams(**params), device="cpu")
    assert ctx.ntt_impl == want
    if env is None or impl == "auto":
        assert want == JContext(JParams(**params)).ntt_impl
    assert hasattr(ctx.tables, "w1f") == (want == "mxu")


def test_fhe_ntt_unknown_value_raises(monkeypatch):
    monkeypatch.setenv("FHE_NTT", "pallas")
    with pytest.raises(ValueError, match="auto, mxu, butterfly"):
        Context(CkksParams(ring_n=1 << 15, mult_depth=2), device="cpu")
