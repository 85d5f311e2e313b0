"""The port's MEHP24 rank sort against the JAX package's on shared keys, ring
512: the matrix ladders against numpy, `sort_fg` at N=4 and 8, `sort_fg_comp`,
`sort_large_array_fg` at N=8 over sub-length 4, and the Chebyshev
comparisons on an explicit domain (`eval_chebyshev_function_ab`).  Output
limb planes bit-equal (tolerance 0); decrypted sorts within 0.01 of
`np.sort`, the reference tests' bound."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu.models.mehp24 import Mehp24Sort as JMehp24Sort
from fhe_sorting_tpu.models.mehp24 import utils as jmu
from fhe_sorting_tpu.ops import rotation as jrot
from fhe_sorting_tpu.ops import sign as jsign
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.models.mehp24 import Mehp24Sort
from fhe_sorting_tpu_torch.models.mehp24 import utils as tmu
from fhe_sorting_tpu_torch.ops import rotation as trot
from fhe_sorting_tpu_torch.ops import sign as tsign

from .utils import vector_with_min_diff

torch.set_num_threads(2)

RING, DEPTH, SUB = 512, 38, 8


@pytest.fixture(scope="module")
def env():
    jctx = JContext(JParams(ring_n=RING, mult_depth=DEPTH))
    jkeys = JKeys.generate(jctx, seed=0)
    steps = jmu.rotation_indices_mehp24(SUB) | jmu.rotation_indices_mehp24(4)
    steps |= {1 << i for i in range(8)} | {-(1 << i) for i in range(8)}
    steps |= {SUB, -SUB, 2 * SUB, -2 * SUB}
    jkeys.gen_rotation_keys(sorted(steps))
    ctx = Context(CkksParams(ring_n=RING, mult_depth=DEPTH), device="cpu")
    keys = Keys.from_numpy(
        ctx, jkeys.s_coeffs, jkeys.s_eval, jkeys.pk[0], jkeys.pk[1],
        np.asarray(jkeys.relin.kb), np.asarray(jkeys.relin.ka),
        rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jkeys.rot.items()})
    return jkeys, JEvaluator(jctx, jkeys), keys, Evaluator(ctx, keys)


def _matrix_input(jkeys, x, sub):
    """Vector in row 0 of a sub x sub matrix, rest zero; in both packages."""
    padded = np.zeros(sub * sub)
    padded[: len(x)] = x
    j = jkeys.encrypt(padded, slots=sub * sub, seed=1)
    return j, Ciphertext.from_numpy(np.asarray(j.data), j.level, j.sdeg, j.slots, "cpu")


def _same(to, jo, what):
    assert (to.level, to.sdeg, to.slots) == (jo.level, jo.sdeg, jo.slots), what
    np.testing.assert_array_equal(to.data.numpy(), np.asarray(jo.data).astype(np.int64), what)


@pytest.mark.parametrize("size", [2, 4, 8, 64, 256, 512, 1024])
def test_rotation_indices_match_jax(size):
    assert tmu.rotation_indices_mehp24(size) == jmu.rotation_indices_mehp24(size)
    assert all(tmu.depth2degree(d) == jmu.depth2degree(d) for d in range(16))


def test_matrix_ops_plain_and_match_jax(env):
    """replicate/transpose/sum ladders against numpy and the JAX planes."""
    jkeys, jev, keys, tev = env
    n = SUB
    x = np.arange(n) / n + 0.1
    jct, ct = _matrix_input(jkeys, x, n)
    jmat = jmu.MatrixOps(jev, jrot.RotationComposer(jev, jmu.rotation_indices_mehp24(n)), n)
    mat = tmu.MatrixOps(tev, trot.RotationComposer(tev, tmu.rotation_indices_mehp24(n)), n)

    VR = mat.replicate_row(ct)
    _same(VR, jmat.replicate_row(jct), "replicate_row")
    np.testing.assert_allclose(keys.decrypt(VR, n * n), np.tile(x, n), atol=2e-3)

    VC = mat.replicate_column(mat.transpose_row(ct, True))
    _same(VC, jmat.replicate_column(jmat.transpose_row(jct, True)), "replicate_column")
    np.testing.assert_allclose(keys.decrypt(VC, n * n), np.repeat(x, n), atol=2e-3)

    SR = mat.sum_rows(VR, True, 1)
    _same(SR, jmat.sum_rows(jmat.replicate_row(jct), True, 1), "sum_rows")
    np.testing.assert_allclose(keys.decrypt(SR, n * n)[n:2 * n], n * x, atol=5e-3)

    SC = mat.transpose_column(mat.sum_columns(VC, True), True)
    _same(SC, jmat.transpose_column(jmat.sum_columns(
        jmat.replicate_column(jmat.transpose_row(jct, True)), True), True), "sum_columns")
    np.testing.assert_allclose(keys.decrypt(SC, n), n * x, atol=5e-3)


def test_split_combine_match_jax(env):
    jkeys, jev, keys, tev = env
    x = np.arange(16) / 16.0
    jct, ct = _matrix_input(jkeys, x, 4)
    steps = {4, -4, 8, -8}                        # 12 is composed from 8 + 4
    jr, tr = jrot.RotationComposer(jev, steps), trot.RotationComposer(tev, steps)
    jparts, parts = jmu.split_ciphertext(jev, jr, jct, 16, 4), tmu.split_ciphertext(tev, tr, ct, 16, 4)
    for i, (p, jp) in enumerate(zip(parts, jparts, strict=True)):
        _same(p, jp, f"split part {i}")
        np.testing.assert_allclose(keys.decrypt(p, 4), x[4 * i: 4 * i + 4], atol=2e-3)
    out = tmu.combine_ciphertext(tev, tr, parts, 4)
    _same(out, jmu.combine_ciphertext(jev, jr, jparts, 4), "combine")
    np.testing.assert_allclose(keys.decrypt(out, 16), x, atol=2e-3)


@pytest.mark.parametrize("N", [4, 8])
def test_sort_fg_matches_jax(env, N):
    jkeys, jev, keys, tev = env
    x = vector_with_min_diff(N, seed=10 + N)
    jct, ct = _matrix_input(jkeys, x, N)
    out = Mehp24Sort(tev, N, sub_length=N).sort_fg(ct, dg_c=2, df_c=2, dg_i=2, df_i=2)
    jout = JMehp24Sort(jev, N, sub_length=N).sort_fg(jct, dg_c=2, df_c=2, dg_i=2, df_i=2)
    _same(out, jout, f"sort_fg N={N}")
    assert np.abs(keys.decrypt(out, N) - np.sort(x)).max() < 0.01


def test_sort_fg_comp_matches_jax(env):
    jkeys, jev, keys, tev = env
    N = 4
    x = vector_with_min_diff(N, seed=3)
    jct, ct = _matrix_input(jkeys, x, N)
    out = Mehp24Sort(tev, N, sub_length=N).sort_fg_comp(
        ct, tsign.SignFunc.CompositeSign, tsign.SignConfig(tsign.CompositeSignConfig(3, 2, 2)), 2, 2)
    jout = JMehp24Sort(jev, N, sub_length=N).sort_fg_comp(
        jct, jsign.SignFunc.CompositeSign, jsign.SignConfig(jsign.CompositeSignConfig(3, 2, 2)), 2, 2)
    _same(out, jout, "sort_fg_comp")
    assert np.abs(keys.decrypt(out, N) - np.sort(x)).max() < 0.01


def test_sort_large_array_fg_matches_jax(env):
    """N > sub_length: split -> multi-ciphertext sortFG -> combine; `sort`
    dispatches to it."""
    jkeys, jev, keys, tev = env
    N, sub = 8, 4
    x = vector_with_min_diff(N, seed=21)
    jct, ct = _matrix_input(jkeys, x, sub)
    srt, jsrt = Mehp24Sort(tev, N, sub_length=sub), JMehp24Sort(jev, N, sub_length=sub)
    out = srt.sort_large_array_fg(ct, 2, 2, 2, 3)
    _same(out, jsrt.sort_large_array_fg(jct, 2, 2, 2, 3), "sort_large_array_fg")
    assert np.abs(keys.decrypt(out, N) - np.sort(x)).max() < 0.01
    assert srt.rot.stats.rotations == jsrt.rot.stats.rotations


@pytest.mark.parametrize("fn", ["compare_cheb", "equal_cheb", "compare_gt_cheb"])
def test_cheb_comparisons_match_jax(env, fn):
    """`eval_chebyshev_function_ab` on the [-2, 2] domain of a difference."""
    jkeys, jev, keys, tev = env
    a = np.array([0.9, 0.1, 0.5, 0.3, 0.7, 0.2, 0.8, 0.4])
    b = np.array([0.1, 0.9, 0.5, 0.7, 0.3, 0.6, 0.4, 0.8])
    (ja, ta), (jb, tb) = _matrix_input(jkeys, a, 4), _matrix_input(jkeys, b, 4)
    out = getattr(tmu, fn)(tev, ta, tb, -2.0, 2.0, 27, error=0.3)
    _same(out, getattr(jmu, fn)(jev, ja, jb, -2.0, 2.0, 27, error=0.3), fn)
    got = keys.decrypt(out, 8)
    assert np.all(np.isfinite(got)) and np.abs(got).max() < 1.5


def test_indicators_match_jax(env):
    jkeys, jev, keys, tev = env
    x = np.array([-0.9, -0.4, 0.0, 0.3, 0.8, 1.7, 2.5, 2.9])
    jct, ct = _matrix_input(jkeys, x, 4)
    out = tmu.indicator_cheb(tev, ct, 0.0, 1.0, -1.0, 3.0, 27)
    _same(out, jmu.indicator_cheb(jev, jct, 0.0, 1.0, -1.0, 3.0, 27), "indicator_cheb")
    out = tmu.indicator_adv_shifted(tev, ct, 3.0, 2, 2)
    _same(out, jmu.indicator_adv_shifted(jev, jct, 3.0, 2, 2), "indicator_adv_shifted")
