"""The plain reference (`portbench/reference/ckks.py`) against what the program encrypts, at small rings on the CPU."""

import numpy as np
import pytest

from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.ntt import host_ntt
from portbench import program, traffic
from portbench.reference import ckks

CHAINS = [dict(ring_n=256, mult_depth=6, scale_bits=56, comp=2, base_limbs=4, dnum=3),
          dict(ring_n=512, mult_depth=5, scale_bits=28, comp=1, base_limbs=2, dnum=3)]


def _ctx(p):
    return Context(CkksParams(**p), device="cpu")


@pytest.mark.parametrize("p", CHAINS)
def test_chain_and_scales_are_the_programs(p):
    ctx = _ctx(p)
    q, scales = ckks.chain(p["ring_n"], p["mult_depth"], p["scale_bits"], p["comp"],
                           p["base_limbs"])
    assert q == list(ctx.q_primes)
    assert [float(s) for s in scales] == [ctx.scale(i, 1) for i in range(p["mult_depth"] + 1)]
    K = -(-len(q) // p["dnum"])
    assert ckks.special_primes(p["ring_n"], 30, K, q) == list(ctx.sp_primes)


@pytest.mark.parametrize("p", CHAINS)
def test_ntt_layout_is_the_programs_and_inverts(p):
    ctx = _ctx(p)
    a = np.random.default_rng(0).integers(0, 2**20, size=p["ring_n"])
    for i in (0, len(ctx.q_primes) - 1):
        r = ckks.Ring(ctx.q_primes[i], p["ring_n"])
        want = host_ntt(a.astype(np.uint64), ctx._host_psi_rev[i], ctx.q_primes[i])
        assert np.array_equal(r.ntt(a), want.astype(np.int64))
        assert np.array_equal(r.intt(r.ntt(a)), a % ctx.q_primes[i])


@pytest.mark.parametrize("p", CHAINS)
def test_unsorted_round_trip_decrypts_to_the_inputs(p):
    """Encrypted by the program with the benchmark's secret, decrypted by
    the reference: fresh, and after a product and a rescale."""
    ctx = _ctx(p)
    s = traffic.secret(p["ring_n"], 2**31 + 7)
    keys = program.keys(ctx, s, traffic.rng(2**31 + 7, traffic.KEYS), [1])
    x = traffic.vectors({"pool": 1, "warmup_sorts": 1, "traced_sorts": 1}, 16, 5)[0]
    ct = program.encrypt(keys, x, 16, seed=9)
    ev = Evaluator(ctx, keys)
    sq = ev.rescale(ev.mult(ct, ct))
    ref = ckks.Decryptor(p, s)
    tol = 1e-9 if p["scale_bits"] == 56 else 1e-4
    for c, want in ((ct, x), (sq, x * x)):
        got = ref.decrypt(c.data.numpy(), c.level, c.sdeg, c.slots)
        assert np.abs(got - want).max() < tol
        assert np.abs(got - keys.decrypt(c)).max() < 1e-12


def test_a_wrong_secret_decrypts_to_noise():
    p = CHAINS[0]
    ctx = _ctx(p)
    s = traffic.secret(p["ring_n"], 1)
    keys = program.keys(ctx, s, traffic.rng(1, traffic.KEYS), [])
    ct = program.encrypt(keys, np.linspace(0.1, 0.9, 8), 8, seed=1)
    other = ckks.Decryptor(p, traffic.secret(p["ring_n"], 2))
    assert np.abs(other.decrypt(ct.data.numpy(), 0, 1, 8) - np.linspace(0.1, 0.9, 8)).max() > 1
