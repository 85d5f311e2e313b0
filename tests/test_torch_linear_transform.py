"""The port's BSGS linear transform against the JAX package's on shared keys:
a dense matrix and FFT-factored diagonal groups, through the hoisted-baby
route and through a RotationComposer, output limb planes bit-equal (tolerance
0).  Decrypted values are held to the reference test's 5e-4 against M z."""

import dataclasses

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.fft_factors import c2s_factors, dense_from_diags
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu.ops import linear_transform as jlt
from fhe_sorting_tpu.ops import rotation as jrot
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.ops import linear_transform as tlt
from fhe_sorting_tpu_torch.ops import rotation as trot

torch.set_num_threads(2)

RING, NH = 256, 128
PARAMS = dict(ring_n=RING, mult_depth=4)


def _dense():
    rng = np.random.default_rng(0)
    return rng.normal(size=(NH, NH)) / NH + 1j * rng.normal(size=(NH, NH)) / NH


@pytest.fixture(scope="module")
def env():
    jctx = JContext(JParams(**PARAMS))
    jkeys = JKeys.generate(jctx, seed=0)
    steps = set(jlt.rotation_indices_linear_transform(NH)) | {1 << i for i in range(7)}
    for g in c2s_factors(RING, 2):
        steps |= jlt.LinearTransform.from_diagonals(None, g, NH).required_rotations()
    jkeys.gen_rotation_keys(sorted(steps))
    ctx = Context(CkksParams(**PARAMS), device="cpu")
    keys = Keys.from_numpy(
        ctx, jkeys.s_coeffs, jkeys.s_eval, jkeys.pk[0], jkeys.pk[1],
        np.asarray(jkeys.relin.kb), np.asarray(jkeys.relin.ka),
        rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jkeys.rot.items()})
    return jkeys, JEvaluator(jctx, jkeys), keys, Evaluator(ctx, keys)


def _cts(jkeys, z, level=0):
    j = jkeys.encrypt(z, level=level, seed=1)
    return j, Ciphertext.from_numpy(np.asarray(j.data), j.level, j.sdeg, j.slots, "cpu")


def _same(to, jo, what):
    assert (to.level, to.sdeg, to.slots) == (jo.level, jo.sdeg, jo.slots), what
    np.testing.assert_array_equal(to.data.numpy(), np.asarray(jo.data).astype(np.int64), what)


def test_helpers_match_jax():
    M = _dense()
    td, jd = tlt.matrix_diagonals(M), jlt.matrix_diagonals(M)
    assert sorted(td) == sorted(jd)
    for d in td:
        np.testing.assert_array_equal(td[d], jd[d])
    for s in (4, 16, 128, 100):
        assert (tlt.rotation_indices_linear_transform(s)
                == jlt.rotation_indices_linear_transform(s))


def test_dense_transform_matches_jax(env):
    jkeys, jev, keys, tev = env
    M = _dense()
    jl, tl = jlt.LinearTransform(jev, M, NH), tlt.LinearTransform(tev, M, NH)
    assert tl.bs == jl.bs and tl.required_rotations() == jl.required_rotations()
    z = np.random.default_rng(1).normal(size=NH) * 0.3
    jct, ct = _cts(jkeys, z)
    out = tl.apply(ct)
    _same(out, jl.apply(jct), "dense LinearTransform.apply")
    np.testing.assert_allclose(keys.decrypt_complex(out, NH), M @ z, atol=5e-4)


@pytest.mark.parametrize("route", ["hoisted", "composer", "composed_steps"])
@pytest.mark.parametrize("scale", [None, 0.75])
def test_from_diagonals_matches_jax(env, route, scale):
    """Both groups of the budget-2 CoeffsToSlots chain, one level each.
    `composed_steps`: a composer over the powers of two only, so most BSGS
    indices are composed from several keyed steps."""
    jkeys, jev, keys, tev = env
    z = np.random.default_rng(2).normal(size=NH) * 0.3
    jct, ct = _cts(jkeys, z)
    want = z.astype(np.complex128)
    for i, g in enumerate(c2s_factors(RING, 2)):
        jr = tr = None
        je, te = jev, tev
        if route == "composer":
            steps = jlt.LinearTransform.from_diagonals(None, g, NH).required_rotations()
            jr, tr = jrot.RotationComposer(jev, steps), trot.RotationComposer(tev, steps)
        elif route == "composed_steps":
            steps = {1 << k for k in range(7)}
            gs = {keys.ctx.galois_element_rot(r) for r in steps}
            je = JEvaluator(jev.ctx, dataclasses.replace(
                jkeys, rot={g_: k for g_, k in jkeys.rot.items() if g_ in gs}))
            te = Evaluator(tev.ctx, dataclasses.replace(
                keys, rot={g_: k for g_, k in keys.rot.items() if g_ in gs}))
            jr, tr = jrot.RotationComposer(je, steps), trot.RotationComposer(te, steps)
        jl = jlt.LinearTransform.from_diagonals(je, g, NH, scale=scale, rot=jr)
        tl = tlt.LinearTransform.from_diagonals(te, g, NH, scale=scale, rot=tr)
        assert tl.bs == jl.bs and tl.required_rotations() == jl.required_rotations()
        jct, ct = jl.apply(jct), tl.apply(ct)
        _same(ct, jct, f"from_diagonals group {i}, {route}")
        if tr is not None:
            assert (tr.stats.rotations, tr.stats.composed) == (jr.stats.rotations, jr.stats.composed)
            assert tr.stats.composed > 0 or route == "composer"
        want = dense_from_diags(g, NH) @ want * (scale if scale is not None else 1.0)
        # the first group carries the chain's 1/nh, so values shrink: compare relatively
        got = keys.decrypt_complex(ct, NH)
        assert np.abs(got - want).max() < 5e-4 * max(1.0, np.abs(want).max())
