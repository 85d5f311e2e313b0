"""The plain reference (`portbench/reference/ckks.py`) against what the program encrypts, at small rings on the CPU."""

import hashlib

import numpy as np
import pytest
import torch

from fhe_sorting_tpu_torch.core.context import CkksParams, Context, _choose_prime_chain
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.ntt import host_ntt
from portbench import program, traffic
from portbench.reference import ckks

CHAINS = [dict(ring_n=256, mult_depth=6, scale_bits=56, comp=2, base_limbs=4, dnum=3),
          dict(ring_n=512, mult_depth=5, scale_bits=28, comp=1, base_limbs=2, dnum=3),
          dict(ring_n=256, mult_depth=6, scale_bits=56, comp=2, base_limbs=4, dnum=3,
               first_mod_bits=30),
          dict(ring_n=512, mult_depth=5, scale_bits=28, comp=1, base_limbs=2, dnum=3,
               first_mod_bits=29)]
# the k-way sort's chain (`utils/kway_run.build`): ring 2^17, depth 42, scale
# 2^56 from prime pairs, base 4, dnum 3, a 30-bit first modulus
KWAY = dict(ring_n=1 << 17, mult_depth=42, scale_bits=56, comp=2, base_limbs=4, dnum=3,
            first_mod_bits=30)


def _ctx(p):
    return Context(CkksParams(**p), device="cpu")


@pytest.mark.parametrize("p", CHAINS)
def test_chain_and_scales_are_the_programs(p):
    ctx = _ctx(p)
    q, scales = ckks.chain(p["ring_n"], p["mult_depth"], p["scale_bits"], p["comp"],
                           p["base_limbs"], p.get("first_mod_bits"))
    assert q == list(ctx.q_primes) == _choose_prime_chain(CkksParams(**p))[0]
    assert [float(s) for s in scales] == [ctx.scale(i, 1) for i in range(p["mult_depth"] + 1)]
    K = -(-len(q) // p["dnum"])
    assert ckks.special_primes(p["ring_n"], 30, K, q) == list(ctx.sp_primes)


@pytest.mark.parametrize("p", [p for p in CHAINS if "first_mod_bits" in p])
def test_a_first_modulus_replaces_the_bottom_limbs_alone(p):
    """The bottom `comp` limbs are the largest primes = 1 mod 2n up to
    2^first_mod_bits + 1; every other limb and every scale stay as without
    the key."""
    args = [p[k] for k in ("ring_n", "mult_depth", "scale_bits", "comp", "base_limbs")]
    q, scales = ckks.chain(*args, p["first_mod_bits"])
    plain, plain_scales = ckks.chain(*args)
    c = p["comp"]
    assert q[c:] == plain[c:] and scales == plain_scales
    assert all(x % (2 * p["ring_n"]) == 1 and x - 1 <= 2 ** p["first_mod_bits"] for x in q[:c])
    assert q[:c] == sorted(q[:c], reverse=True) and q[:c] != plain[:c]


def test_the_kway_chain_from_the_chain_functions_alone():
    """At ring 2^17 with no Context built: the program's and the reference's
    chains agree, the ModRaise base q0 (the bottom pair) lies above the
    scale 2^56 only with the key, and logQP keeps within HEStd_128_classic."""
    args = [KWAY[k] for k in ("ring_n", "mult_depth", "scale_bits", "comp", "base_limbs")]
    q, scales = ckks.chain(*args, KWAY["first_mod_bits"])
    mine, mine_scales = _choose_prime_chain(CkksParams(**KWAY))
    assert q == mine and scales == mine_scales
    assert q[:2] == [1073479681, 1068236801] and q[0] * q[1] > 2**56
    plain = ckks.chain(*args)[0]
    assert plain[:2] == [169869313, 167772161] and plain[0] * plain[1] < 2**56
    assert plain[2:] == q[2:] and len(q) == 88
    sp = ckks.special_primes(KWAY["ring_n"], 30, -(-len(q) // KWAY["dnum"]), q)
    assert len(sp) == 30 and ckks.logqp_bits(q + sp) <= 3524


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


# the relinearisation and rotation keys (steps 1, 2, -3) of CHAINS[0] and the
# seed below, as the benchmark drew them before a builder could ask for the
# conjugation key
KEYS_DIGEST = "77fde74fba7326b83dac074d4889203f"


def _digest(keys, gs):
    h = hashlib.sha256()
    for k in [keys.relin] + [keys.rot[g] for g in gs]:
        h.update(k.kb.numpy().tobytes())
        h.update(k.ka.numpy().tobytes())
    return h.hexdigest()[:32]


def test_the_conjugation_key_is_drawn_only_on_request():
    """Drawn last from the same stream: every other key keeps its bits."""
    p = CHAINS[0]
    ctx = _ctx(p)
    seed = 2**31 + 7
    s = traffic.secret(p["ring_n"], seed)
    conj = 2 * p["ring_n"] - 1
    plain = program.keys(ctx, s, traffic.rng(seed, traffic.KEYS), [1, 2, -3])
    asked = program.keys(ctx, s, traffic.rng(seed, traffic.KEYS), [1, 2, -3],
                         conjugation_key=True)
    assert conj not in plain.rot and conj in asked.rot
    assert set(asked.rot) == set(plain.rot) | {conj}
    gs = sorted(plain.rot)
    assert _digest(plain, gs) == _digest(asked, gs) == KEYS_DIGEST
    again = program.keys(ctx, s, traffic.rng(seed, traffic.KEYS), [1, 2, -3],
                         conjugation_key=True)
    assert torch.equal(again.rot[conj].kb, asked.rot[conj].kb)
    assert torch.equal(again.rot[conj].ka, asked.rot[conj].ka)


@pytest.mark.parametrize("p", [CHAINS[0], CHAINS[2]])
def test_a_conjugated_encryption_decrypts_to_its_input(p):
    """Real slots are their own conjugates: the program's conjugation under
    the benchmark's conjugation key decrypts, by the reference, to the
    input."""
    ctx = _ctx(p)
    seed = 2**31 + 8
    s = traffic.secret(p["ring_n"], seed)
    keys = program.keys(ctx, s, traffic.rng(seed, traffic.KEYS), [], conjugation_key=True)
    x = traffic.vectors({"pool": 1, "warmup_sorts": 1, "traced_sorts": 1}, 16, 6)[0]
    ct = program.encrypt(keys, x, 16, seed=10)
    out = Evaluator(ctx, keys).conjugate(ct)
    got = ckks.Decryptor(p, s).decrypt(out.data.numpy(), out.level, out.sdeg, out.slots)
    assert np.abs(got - x).max() < 1e-9
