"""The port's hoisted rotations, conjugation and rotation engine against the
JAX package.

Evaluator ops run on identical inputs: the JAX package's keys (rotation and
conjugation keys included), ciphertexts and hoisted precomputes, converted
through numpy, so every output limb plane must be equal (tolerance 0).  The
decomposer and the composers must pick the same steps, count the same stats
and evict the same lazy keys."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu.ops import rotation as jrot
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.ops import rotation as trot

torch.set_num_threads(2)

PARAMS = dict(ring_n=1024, mult_depth=4)
STEPS = [1, 2, 4, -1, 5]


def _eq(t, j, what=""):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j).astype(np.int64), what)


def keys_from_jax(ctx, jk):
    g_conj = 2 * ctx.params.ring_n - 1
    pair = lambda k: (np.asarray(k.kb), np.asarray(k.ka))
    return Keys.from_numpy(
        ctx, jk.s_coeffs, jk.s_eval, jk.pk[0], jk.pk[1], *pair(jk.relin),
        rot={g: pair(k) for g, k in jk.rot.items() if g != g_conj},
        conj=pair(jk.rot[g_conj]) if g_conj in jk.rot else None)


def ct_from_jax(c):
    return Ciphertext.from_numpy(np.asarray(c.data), c.level, c.sdeg, c.slots, "cpu")


@pytest.fixture(scope="module")
def pair():
    jc = JContext(JParams(**PARAMS))
    jk = JKeys.generate(jc, seed=0)
    jk.gen_rotation_keys(STEPS)
    jk.gen_conj_key()
    tc = Context(CkksParams(**PARAMS), device="cpu")
    tk = keys_from_jax(tc, jk)
    assert tk.available_rotations() == jk.available_rotations()
    return jk, JEvaluator(jc, jk), tk, Evaluator(tc, tk)


def _inputs(jk, jev, level, sdeg, seed=1):
    x = np.random.default_rng(seed).uniform(-1, 1, 512)
    ja = jk.encrypt(x, level=level, seed=seed)
    if sdeg == 2:
        ja = jev.mult(ja, 0.5)
    return x, ja, ct_from_jax(ja)


@pytest.mark.parametrize("level,sdeg", [(0, 1), (1, 2), (2, 1)])
def test_hoisted_rotations_match_jax(pair, level, sdeg):
    jk, jev, tk, tev = pair
    x, ja, ta = _inputs(jk, jev, level, sdeg)
    jpre, tpre = jev.rotate_precompute(ja), tev.rotate_precompute(ta)
    _eq(tpre, jpre, "hoisted precompute")
    # the precompute carries across as numpy: [dnum digits, Ll+K, n]
    tpre_from_j = tev.ctx.tensor(np.asarray(jpre))
    assert tpre.shape == (len(tev.ctx.digit_layout(level)),
                          tev.ctx.limbs_at(level) + tev.ctx.num_sp, 1024)
    for r in (1, -1, 5, 0):
        jo, to = jev.rotate_hoisted(ja, jpre, r), tev.rotate_hoisted(ta, tpre_from_j, r)
        assert (to.level, to.sdeg, to.slots) == (jo.level, jo.sdeg, jo.slots)
        _eq(to.data, jo.data, f"rotate_hoisted {r} at level {level}, sdeg {sdeg}")
    # hoisted and direct rotations agree after decryption, up to key-switch
    # noise (their extension noise differs; at a 2^28 scale it is ~1e-4)
    got = tk.decrypt(tev.rotate_hoisted(ta, tpre, 5))
    np.testing.assert_allclose(got, tk.decrypt(tev.rotate(ta, 5)), atol=1e-3)
    assert tev.op_stats[("rot_pre", level)] == 1 and tev.op_stats[("rot_hoisted", level)] == 4


@pytest.mark.parametrize("level,sdeg", [(0, 1), (1, 2)])
def test_conjugate_matches_jax(pair, level, sdeg):
    jk, jev, tk, tev = pair
    z = np.random.default_rng(3).uniform(-1, 1, 512) + 1j * np.random.default_rng(4).uniform(-1, 1, 512)
    ja = jk.encrypt(z, level=level, seed=2)
    if sdeg == 2:
        ja = jev.mult(ja, 0.5)
    ta = ct_from_jax(ja)
    jo, to = jev.conjugate(ja), tev.conjugate(ta)
    _eq(to.data, jo.data, "conjugate")
    np.testing.assert_array_equal(tk.decrypt_complex(to), jk.decrypt_complex(jo))
    scale = 0.5 if sdeg == 2 else 1.0
    np.testing.assert_allclose(tk.decrypt_complex(to), np.conj(z) * scale, atol=1e-3)  # 2^28 scale
    np.testing.assert_array_equal(tk.decrypt(to, 7), jk.decrypt(jo, 7))


def test_own_keys_rotate_hoisted_and_conjugate():
    """The port's own relin, rotation and conjugation keys (device generator,
    one step at a time as the lazy pool asks) decrypt correctly."""
    ctx = Context(CkksParams(ring_n=1024, mult_depth=3, scale_bits=56, comp=2, base_limbs=4),
                  device="cpu")
    keys = Keys.generate(ctx, seed=0)
    for r in (3, -2):
        keys.gen_rotation_keys([r])
    keys.gen_conj_key()
    keys.gen_relin_key()
    assert len(keys.available_rotations()) == 3
    ev = Evaluator(ctx, keys)
    z = np.random.default_rng(2).uniform(-1, 1, 512) * (1 + 0.5j)
    ct = ev.rescale(ev.square(keys.encrypt(z, seed=1)))
    pre = ev.rotate_precompute(ct)
    np.testing.assert_allclose(keys.decrypt_complex(ev.rotate_hoisted(ct, pre, 3)),
                               np.roll(z * z, -3), atol=1e-6)
    np.testing.assert_allclose(keys.decrypt_complex(ev.rotate_hoisted(ct, pre, -2)),
                               np.roll(z * z, 2), atol=1e-6)
    np.testing.assert_allclose(keys.decrypt_complex(ev.conjugate(ct)), np.conj(z * z), atol=1e-6)


@pytest.mark.parametrize("algo", ["NAF", "BNAF", "BINARY"])
@pytest.mark.parametrize("steps", [
    (1, 2, 4, 8, 16, 32, 64, 128, 256),
    (1, 2, 4, 8, 24, 96, 256),
    (1, -1, 4, -4, 16, -16, 64, -64),
    (3, 5),
])
def test_decomposer_matches_jax(steps, algo):
    assert trot.naf_digits(0b1011101) == jrot.naf_digits(0b1011101)
    td = trot.Decomposer(steps, 512, trot.DecomposeAlgo[algo])
    jd = jrot.Decomposer(steps, 512, jrot.DecomposeAlgo[algo])
    for r in list(range(-40, 41)) + [100, 255, 300, 511]:
        try:
            ref = jd.decompose(r)
        except ValueError:
            with pytest.raises(ValueError):
                td.decompose(r)
            continue
        got = td.decompose(r)
        assert got == ref, (r, got, ref)
        assert sum(got) % 512 == r % 512


def _stats(s):
    return (s.rotations, s.fast_rotations, s.composed, s.lazy_keygens, dict(s.calls))


def test_rotation_composer_matches_jax(pair):
    jk, jev, tk, tev = pair
    x, ja, ta = _inputs(jk, jev, 0, 1, seed=5)
    jc_, tc_ = jrot.RotationComposer(jev, STEPS), trot.RotationComposer(tev, STEPS)
    jpre, tpre = jev.rotate_precompute(ja), tev.rotate_precompute(ta)
    for r in (1, 3, 7, -2, 0, 6):
        _eq(tc_.rotate(ta, r).data, jc_.rotate(ja, r).data, f"composed rotate {r}")
        _eq(tc_.rotate_hoisted(ta, tpre, r).data, jc_.rotate_hoisted(ja, jpre, r).data,
            f"composed hoisted rotate {r}")
    assert _stats(tc_.stats) == _stats(jc_.stats)

    jtree, ttree = jrot.RotationTree(jc_).build(ja, [3, 7]), trot.RotationTree(tc_).build(ta, [3, 7])
    for r in (3, 7, 6, 3):
        _eq(ttree.rotate(r).data, jtree.rotate(r).data, f"tree rotate {r}")
    assert _stats(tc_.stats) == _stats(jc_.stats)
    np.testing.assert_allclose(tk.decrypt(ttree.rotate(7)), np.roll(x, -7), atol=1e-3)  # 2^28 scale


def test_lazy_key_pool_matches_jax():
    """Both lazy pools generate on demand, refresh on reuse and evict the
    same (least recently used) keys; keys present beforehand stay."""
    jc = JContext(JParams(ring_n=256, mult_depth=2))
    jk = JKeys.generate(jc, seed=0)
    jk.gen_rotation_keys([1])
    tc = Context(CkksParams(ring_n=256, mult_depth=2), device="cpu")
    tk = Keys.generate(tc, seed=0)
    tk.gen_rotation_keys([1])
    jev, tev = JEvaluator(jc, jk), Evaluator(tc, tk)
    x = np.random.default_rng(0).uniform(-1, 1, 128)
    ja, ta = jk.encrypt(x, seed=1), tk.encrypt(x, seed=1)
    _eq(ta.data, ja.data)
    jc_ = jrot.RotationComposer(jev, [1], lazy_key_budget=2)
    tc_ = trot.RotationComposer(tev, [1], lazy_key_budget=2)
    for r in (3, 5, 3, 9, 1, 5, 11):
        jo, to = jc_.rotate(ja, r), tc_.rotate(ta, r)
        # the key-switch `a` differs between the packages: compare decrypted
        np.testing.assert_allclose(tk.decrypt(to), np.roll(x, -r), atol=1e-3)
        np.testing.assert_allclose(jk.decrypt(jo), np.roll(x, -r), atol=1e-3)
        assert tk.available_rotations() == jk.available_rotations(), r
        assert tc_._lazy_lru == jc_._lazy_lru
    assert _stats(tc_.stats) == _stats(jc_.stats)
    assert tc_.stats.lazy_keygens == 5 and len(tk.rot) == 3
    assert tc.galois_element_rot(1) in tk.rot
