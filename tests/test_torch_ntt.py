"""The PyTorch port's modular arithmetic and NTTs against the JAX package.

Same inputs (numpy, seeded) through both; every comparison is bit-exact
(tolerance 0), since both compute canonical residues mod p.  The JAX
four-step runs both as its XLA path and as the Pallas kernel in interpret
mode, the way tests/test_ntt.py runs it on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core import modmath as jmod
from fhe_sorting_tpu.core import ntt as jntt
from fhe_sorting_tpu.core import ntt_mxu as jmxu
from fhe_sorting_tpu.core import pallas_fs_ntt
from fhe_sorting_tpu.core import primes
from fhe_sorting_tpu_torch.core import modmath as tmod
from fhe_sorting_tpu_torch.core import ntt as tntt
from fhe_sorting_tpu_torch.core import ntt_mxu as tmxu

torch.set_num_threads(2)


def _residues(rng, ps, shape):
    """Random canonical residues [..., L, n] for primes ps (u64)."""
    return np.stack([rng.integers(0, p, size=shape, dtype=np.uint64) for p in ps], axis=-2)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_modmath_matches_jax():
    rng = np.random.default_rng(0)
    ps = primes.ntt_primes(1024, 30, 3)
    a = _residues(rng, ps, (512,))
    b = _residues(rng, ps, (512,))
    a[:, :8] = 0                                 # exercise the zero branches
    pcol = np.asarray(ps, dtype=np.uint64)[:, None]
    pj = jnp.asarray(pcol.astype(np.uint32))
    aj, bj = jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32))
    at, bt, pt = _t(a), _t(b), _t(pcol)

    np.testing.assert_array_equal(tmod.add_mod(at, bt, pt).numpy(), np.asarray(jmod.add_mod(aj, bj, pj)))
    np.testing.assert_array_equal(tmod.sub_mod(at, bt, pt).numpy(), np.asarray(jmod.sub_mod(aj, bj, pj)))
    np.testing.assert_array_equal(tmod.neg_mod(at, pt).numpy(), np.asarray(jmod.neg_mod(aj, pj)))
    consts = [jmod.PrimeConsts(p) for p in ps]
    col = lambda f: jnp.asarray(np.array([getattr(c, f) for c in consts])[:, None])
    barrett = jmod.barrett_mulmod(aj, bj, pj, col("r2_32"), col("r2_32_shoup"), col("p_inv32"))
    np.testing.assert_array_equal(tmod.mulmod(at, bt, pt).numpy(), np.asarray(barrett))
    bsh = jnp.asarray(np.stack([jmod.host_shoup(b[i], p) for i, p in enumerate(ps)]))
    np.testing.assert_array_equal(tmod.mulmod(at, bt, pt).numpy(),
                                  np.asarray(jmod.shoup_mulmod(aj, bj, bsh, pj)))


@pytest.mark.parametrize("n", [64, 256, 1024])
def test_butterfly_matches_jax(n):
    ps = primes.ntt_primes(n, 28, 3)
    jt = jntt.build_device_tables(ps, n)
    tt = tntt.build_device_tables(ps, n, "cpu")
    for f in ("p", "n_inv", "psi_rev", "ipsi_rev"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), f)
    a = _residues(np.random.default_rng(n), ps, (2, n))
    f_j = np.asarray(jntt.ntt(jnp.asarray(a.astype(np.uint32)), jt))
    f_t = tntt.ntt(_t(a), tt)
    np.testing.assert_array_equal(f_t.numpy(), f_j)
    np.testing.assert_array_equal(tntt.intt(f_t, tt).numpy(),
                                  np.asarray(jntt.intt(jnp.asarray(f_j), jt)))
    np.testing.assert_array_equal(tntt.intt(f_t, tt).numpy(), a.astype(np.int64))
    # a limb subset through the index vector equals the sliced tables
    sub = torch.tensor([2, 0])
    np.testing.assert_array_equal(tntt.ntt(_t(a)[:, [2, 0]], tt, sub).numpy(), f_j[:, [2, 0]])


def _digits_to_residues(d):
    """[4, ...] s8 balanced digits -> sum_a d_a 256^a."""
    d = np.asarray(d).astype(np.int64)
    return sum(d[a] << (8 * a) for a in range(4))


@pytest.mark.parametrize("n", [256, 1024])
def test_four_step_plain_matches_jax(n):
    ps = primes.ntt_primes(n, 28, 2)
    jt = jmxu.build_fs_tables(ps, n)
    tt = tmxu.build_fs_tables(ps, n, "cpu")
    np.testing.assert_array_equal(tt.p.numpy(), np.asarray(jt.p))
    for f in ("w1f", "w2f", "w2i", "w1i"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      _digits_to_residues(getattr(jt, f)), f)
    for f in ("tf", "tf_sh", "ti", "ti_sh"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), f)

    a = _residues(np.random.default_rng(5), ps, (2, n))
    aj = jnp.asarray(a.astype(np.uint32))
    f_xla = np.asarray(jmxu.ntt_fs(aj, jt))
    f_pl = np.asarray(pallas_fs_ntt.ntt_fs_pallas(aj, jt, interpret=True))
    f_t = tmxu.ntt_fs(_t(a), tt)
    np.testing.assert_array_equal(f_t.numpy(), f_xla)
    np.testing.assert_array_equal(f_t.numpy(), f_pl)
    fj = jnp.asarray(f_xla)
    r_t = tmxu.intt_fs(f_t, tt)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(jmxu.intt_fs(fj, jt)))
    np.testing.assert_array_equal(r_t.numpy(),
                                  np.asarray(pallas_fs_ntt.intt_fs_pallas(fj, jt, interpret=True)))
    np.testing.assert_array_equal(r_t.numpy(), a.astype(np.int64))


def test_mod_matmul_matches_jax_digit_matmuls():
    rng = np.random.default_rng(7)
    ps = primes.ntt_primes(1024, 30, 3)
    pcol = np.asarray(ps, dtype=np.uint64)
    # per-limb product (_mm_mod): [L, M, K] @ [L, K, N]
    A = np.stack([rng.integers(0, p, size=(5, 40), dtype=np.uint64) for p in ps])
    B = np.stack([rng.integers(0, p, size=(40, 9), dtype=np.uint64) for p in ps])
    p3 = pcol[:, None, None]
    sh = jnp.asarray(np.array([jmod.host_shoup(np.uint64(256), p) for p in ps])[:, None, None])
    digits = lambda x: jmxu._balanced_digits_host(x)
    ref = jmxu._mm_mod(jnp.asarray(digits(A)), jnp.asarray(digits(B)),
                       jnp.asarray(p3.astype(np.uint32)), sh)
    np.testing.assert_array_equal(tmxu.mod_matmul(_t(A), _t(B), _t(p3)).numpy(), np.asarray(ref))
    # per-row modulus (mod_matmul_digits): [M, K] @ [K, N] mod p_row
    F = np.stack([rng.integers(0, p, size=23, dtype=np.uint64) for p in ps])      # [3, 23]
    Y = rng.integers(0, min(ps), size=(23, 64), dtype=np.uint64)
    ref = jmxu.mod_matmul_digits(jnp.asarray(digits(F)), jnp.asarray(digits(Y)),
                                 jnp.asarray(pcol[:, None].astype(np.uint32)), sh[:, :, 0])
    np.testing.assert_array_equal(tmxu.mod_matmul(_t(F), _t(Y), _t(pcol[:, None])).numpy(),
                                  np.asarray(ref))
