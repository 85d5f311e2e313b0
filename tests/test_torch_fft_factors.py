"""The port's own copy of the FFT-factored embedding transform against the
JAX package's: the generalized diagonals of every group must be bit-equal
complex128 (`array_equal`, tolerance 0), because every plaintext of the
bootstrap's CoeffsToSlots / SlotsToCoeffs is encoded from them."""

import numpy as np
import pytest

from fhe_sorting_tpu.core import fft_factors as jff
from fhe_sorting_tpu_torch.core import fft_factors as tff


def _same_groups(tg, jg):
    assert len(tg) == len(jg)
    for t, j in zip(tg, jg):
        assert sorted(t) == sorted(j)
        for d in t:
            assert t[d].dtype == j[d].dtype == np.complex128
            np.testing.assert_array_equal(t[d], j[d])


@pytest.mark.parametrize("budget", [1, 2, 3])
@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("kind", ["c2s_factors", "s2c_factors"])
def test_factors_equal_jax(kind, n, budget):
    _same_groups(getattr(tff, kind)(n, budget), getattr(jff, kind)(n, budget))


@pytest.mark.parametrize("n", [64, 256])
def test_stage_diagonals_equal_jax(n):
    _same_groups(tff.stage_diagonals(n), jff.stage_diagonals(n))


def test_factors_compose_to_the_embedding():
    """S2C groups multiply to E P and C2S groups to P conj(E)^T / nh."""
    n, nh = 64, 32
    E = tff.embedding_matrix(n)
    np.testing.assert_array_equal(E, jff.embedding_matrix(n))
    bits = nh.bit_length() - 1
    P = np.zeros((nh, nh))
    for i in range(nh):
        P[i, tff._bitrev(i, bits)] = 1.0
    for budget in (1, 2, 3):
        s2c = np.eye(nh, dtype=np.complex128)
        for g in tff.s2c_factors(n, budget):
            s2c = tff.dense_from_diags(g, nh) @ s2c
        np.testing.assert_allclose(s2c, E @ P, atol=1e-12)
        c2s = np.eye(nh, dtype=np.complex128)
        for g in tff.c2s_factors(n, budget):
            c2s = tff.dense_from_diags(g, nh) @ c2s
        np.testing.assert_allclose(c2s, P @ np.conj(E).T / nh, atol=1e-12)


def test_diag_helpers_equal_jax():
    rng = np.random.default_rng(0)
    nh = 16
    A = {d: rng.normal(size=nh) + 1j * rng.normal(size=nh) for d in (0, 1, 5)}
    B = {d: rng.normal(size=nh) + 1j * rng.normal(size=nh) for d in (0, 3)}
    _same_groups([tff.diag_mul(A, B, nh)], [jff.diag_mul(A, B, nh)])
    _same_groups([tff.diag_transpose_conj(A, nh)], [jff.diag_transpose_conj(A, nh)])
    np.testing.assert_allclose(
        tff.dense_from_diags(tff.diag_mul(A, B, nh), nh),
        tff.dense_from_diags(A, nh) @ tff.dense_from_diags(B, nh), atol=1e-12)
