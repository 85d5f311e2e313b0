"""K2's function (the merged-twiddle butterfly NTT) in the port against the JAX
package, and the pass structure of the CUDA kernel against the plain version.

Same inputs (numpy, seeded) through both packages; every comparison is
bit-exact (tolerance 0), since all of them compute canonical residues mod p.
The JAX side runs both its XLA butterfly and the Pallas kernel K2 in
interpret mode.  The CUDA kernel itself cannot run without a card
(tests/test_torch_kernels.py holds it against the plain version there); what
runs here is `_model_transform`, a numpy transcription of the kernel's cluster
form and index arithmetic (`csrc/bf_ntt.cu`), with `_passes`, the kernel's
schedule of rounds (`pick_round`, `LAST`), transcribed beside it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core import ntt as jntt
from fhe_sorting_tpu.core import pallas_ntt
from fhe_sorting_tpu.core import primes as jprimes
from fhe_sorting_tpu_torch.core import bf_ntt
from fhe_sorting_tpu_torch.core import ntt as tntt
from fhe_sorting_tpu_torch.core import primes as tprimes
from fhe_sorting_tpu_torch.core.context import CkksParams, Context

torch.set_num_threads(2)


def _residues(rng, ps, shape):
    return np.stack([rng.integers(0, p, size=shape, dtype=np.uint64) for p in ps], axis=-2)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("subset", [None, (2, 0)])
@pytest.mark.parametrize("n", [1 << 10, 1 << 12])
def test_butterfly_matches_jax_and_pallas_k2(n, subset):
    ps = jprimes.ntt_primes(n, 28, 3)
    assert tprimes.ntt_primes(n, 28, 3) == ps
    jt = jntt.build_device_tables(ps, n)
    tt = tntt.build_device_tables(ps, n, "cpu")
    np.testing.assert_array_equal(tt.psi_rev.numpy(), np.asarray(jt.psi_rev))
    np.testing.assert_array_equal(tt.ipsi_rev.numpy(), np.asarray(jt.ipsi_rev))
    a = _residues(np.random.default_rng(n), ps, (2, n))
    limbs = None
    if subset is not None:
        a = a[:, list(subset)]
        jt = jt.slice(2, 3).concat(jt.slice(0, 1))      # limbs (2, 0)
        limbs = torch.tensor(subset)
    aj = jnp.asarray(a.astype(np.uint32))
    f_xla = np.asarray(jntt.ntt(aj, jt))
    f_pl = np.asarray(pallas_ntt.ntt_pallas(aj, jt, interpret=True))
    f_t = tntt.ntt(_t(a), tt, limbs)
    np.testing.assert_array_equal(f_t.numpy(), f_xla)
    np.testing.assert_array_equal(f_t.numpy(), f_pl)
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(bf_ntt.butterfly(_t(a), tt, limbs, False), f_t)
    fj = jnp.asarray(f_xla)
    r_t = tntt.intt(f_t, tt, limbs)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(jntt.intt(fj, jt)))
    np.testing.assert_array_equal(r_t.numpy(),
                                  np.asarray(pallas_ntt.intt_pallas(fj, jt, interpret=True)))
    np.testing.assert_array_equal(r_t.numpy(), a.astype(np.int64))


LAST = 5           # stages of the kernel's last round: 32 adjacent residues a thread
ROUND = 3          # most stages of a round before it


def _passes(logn, c):
    """[(s0, s1)] in forward order: the stage ranges the kernel runs together
    in registers for a cluster of 2^c blocks.  The first is the radix-2^c step
    across blocks (absent for c = 0), the last the round on adjacent
    residues, between them rounds of three stages (a rest of four as two
    twos)."""
    lm = logn - c
    early = lm - min(lm, LAST)
    out = [(0, c)] if c else []
    t = 0
    while t < early:
        left = early - t
        r = 2 if left == 4 else min(left, ROUND)
        out.append((c + t, c + t + r))
        t += r
    out.append((c + early, logn))
    return out


def _valid_clusters(logn):
    """Cluster sizes (log2) the kernel accepts for ring 2^logn."""
    return [c for c in range(bf_ntt.MAX_LOG_CLUSTER + 1)
            if 1 + c <= logn - c <= bf_ntt.LOG_CHUNK]


@pytest.mark.parametrize("logn", range(1, 22))
def test_pass_plan_covers_every_stage_once(logn):
    for c in _valid_clusters(logn):
        plan = _passes(logn, c)
        assert plan[0][0] == 0 and plan[-1][1] == logn
        for (s0, s1), nxt in zip(plan, plan[1:] + [None]):
            assert s0 < s1
            if nxt is not None:
                assert nxt[0] == s1
        if c:
            assert plan[0] == (0, c)                         # the radix-2^c step across blocks
        local = plan[1:] if c else plan
        assert all(s1 - s0 <= ROUND for s0, s1 in local[:-1])
        assert local[-1][1] - local[-1][0] == min(LAST, logn - c)
    if logn > bf_ntt.LOG_CHUNK + bf_ntt.MAX_LOG_CLUSTER:
        assert _valid_clusters(logn) == []
        with pytest.raises(ValueError):
            bf_ntt.cluster_log(logn)
        return
    assert bf_ntt.cluster_log(logn) in _valid_clusters(logn)
    if logn <= bf_ntt.LOG_CHUNK:
        assert bf_ntt.cluster_log(logn) == 0 and len(_passes(logn, 0)) <= 4
    if logn == 17:
        assert bf_ntt.cluster_log(17) == 3
        assert _passes(17, 3) == [(0, 3), (3, 6), (6, 9), (9, 12), (12, 17)]


M32 = np.uint64(0xFFFFFFFF)


def _phys(i):
    """The padded position of local residue i in a block's shared memory."""
    return i + ((i >> 5) << 2)


def _shoup(a, w, wsh, p):
    """a * w mod p as the kernel computes it, in 32 bits."""
    r = (a * w - ((a * wsh) >> np.uint64(32)) * p) & M32
    assert (a * w - ((a * wsh) >> np.uint64(32)) * p < 2 * p).all()
    return np.where(r >= p, r - p, r)


def _mul_lazy(a, w, wsh, p):
    """a * w - hi32(a * w') * p in 32 bits: congruent to a * w, in [0, 2p)."""
    assert (a <= M32).all()
    exact = a * w - ((a * wsh) >> np.uint64(32)) * p
    assert (exact < 2 * p).all()
    return exact & M32


def _reg_stages(v, pack, p, R, s0, pre, inverse, lazy):
    """`reg_stages` of the kernel: R stages on the 2^R slots v[e] (arrays over
    the threads' groups), twiddle index 2^(s0+j) + (pre << j) + (e >> (R-j)).
    `lazy`: Harvey's butterflies, forward values in [0, 4p), inverse in [0, 2p)."""
    if lazy:
        assert 4 * int(p) <= 1 << 32
    for jj in range(R):
        j = R - 1 - jj if inverse else jj
        half = 1 << (R - 1 - j)
        for e in range(1 << R):
            if e & half:
                continue
            tw = pack[(1 << (s0 + j)) + (pre << j) + (e >> (R - j))]
            w, wsh = tw & M32, tw >> np.uint64(32)
            a, b = v[e].copy(), v[e + half].copy()
            if lazy and not inverse:
                assert (a < 4 * p).all() and (b < 4 * p).all()
                x = np.where(a >= 2 * p, a - 2 * p, a)
                t = _mul_lazy(b, w, wsh, p)
                v[e], v[e + half] = x + t, x + 2 * p - t
            elif lazy:
                assert (a < 2 * p).all() and (b < 2 * p).all()
                t = a + 2 * p - b
                v[e] = np.where(a + b >= 2 * p, a + b - 2 * p, a + b)
                v[e + half] = _mul_lazy(t, w, wsh, p)
            elif not inverse:
                bw = _shoup(b, w, wsh, p)
                v[e], v[e + half] = (a + bw) % p, (a + p - bw) % p
            else:
                v[e], v[e + half] = (a + b) % p, _shoup((a + p - b) % p, w, wsh, p)


def _local_rounds(sm, pack, p, logn, c, rank, inverse, lazy):
    """The rounds inside block `rank` on its padded chunk sm."""
    lm = logn - c
    plan = _passes(logn, c)[1 if c else 0:]
    for k, (s0, s1) in enumerate(plan[::-1] if inverse else plan):
        t0, R = s0 - c, s1 - s0
        gi = np.arange(1 << (lm - R))
        if s1 == logn:                                  # adjacent residues
            at = _phys(gi << R)
            idx = [at + e for e in range(1 << R)]
            assert all((idx[e] == _phys((gi << R) + e)).all() for e in range(1 << R))
            hi = gi
        else:
            lowbits = lm - t0 - R
            lo, hi = gi & ((1 << lowbits) - 1), gi >> lowbits
            idx = [_phys(((hi << (lm - t0)) | lo) + (e << lowbits)) for e in range(1 << R)]
        v = [sm[ix] for ix in idx]
        _reg_stages(v, pack, p, R, c + t0, (rank << t0) + hi, inverse, lazy)
        for ix, val in zip(idx, v):
            sm[ix] = val


def _model_transform(x, t, limb, inverse, c):
    """One plane x [n] (u64) through the kernel's cluster form, block by
    block, with its index arithmetic: which block holds which residues, the
    radix-2^c step between device memory and the blocks, the padded chunk,
    the rounds and their twiddle indices, the packed Shoup twiddles."""
    n = x.shape[0]
    logn = n.bit_length() - 1
    lm, C = logn - c, 1 << c
    m = 1 << lm
    pack = (t.ipsi_pack if inverse else t.psi_pack)[limb].numpy().view(np.uint64)
    p, ninv = np.uint64(int(t.p[limb])), np.uint64(int(t.n_inv[limb]))
    lazy = t.lazy
    unset = np.uint64(1 << 40)
    sm = [np.full(_phys(m), unset) for _ in range(C)]
    out = np.full(n, unset)
    items = np.arange((m >> c) >> 1)
    if not inverse:
        for rank in range(C):
            j = rank * (m >> c) + 2 * items
            for lane in range(2):
                v = [x[(e << lm) + j + lane] for e in range(C)]
                _reg_stages(v, pack, p, c, 0, 0, False, lazy)
                for e in range(C):
                    sm[e][_phys(j) + lane] = v[e]
        for rank in range(C):
            _local_rounds(sm[rank], pack, p, logn, c, rank, False, lazy)
            got = sm[rank][_phys(np.arange(m))]
            if lazy:                                    # [0, 4p) -> [0, p) on the way out
                got = np.where(got >= 2 * p, got - 2 * p, got)
                got = np.where(got >= p, got - p, got)
            out[(rank << lm) + np.arange(m)] = got
    else:
        for rank in range(C):
            sm[rank][_phys(np.arange(m))] = x[(rank << lm) + np.arange(m)]
            _local_rounds(sm[rank], pack, p, logn, c, rank, True, lazy)
        nsh = (ninv << np.uint64(32)) // p
        for rank in range(C):
            j = rank * (m >> c) + 2 * items
            for lane in range(2):
                v = [sm[e][_phys(j) + lane] for e in range(C)]
                _reg_stages(v, pack, p, c, 0, 0, True, lazy)
                for e in range(C):
                    out[(e << lm) + j + lane] = _shoup(v[e], ninv, nsh, p)
    assert (out < p).all()                              # every residue written, canonical
    return out


def _check_model(logn, c, bits=30, limbs=2):
    n = 1 << logn
    ps = tprimes.ntt_primes(n, bits, limbs)
    t = tntt.build_device_tables(ps, n, "cpu")
    assert t.lazy == (bits <= 30)               # delayed reductions need 4p below 2^32
    a = _residues(np.random.default_rng(logn), ps, (n,))          # [limbs, n]
    fwd = tntt.butterfly_plain(_t(a)[None], t, None, False)[0]
    inv = tntt.butterfly_plain(fwd[None], t, None, True)[0]
    for limb in range(limbs):
        got = _model_transform(a[limb], t, limb, False, c)
        np.testing.assert_array_equal(got.astype(np.int64), fwd[limb].numpy())
        back = _model_transform(got, t, limb, True, c)
        np.testing.assert_array_equal(back.astype(np.int64), inv[limb].numpy())
        np.testing.assert_array_equal(back, a[limb])


@pytest.mark.parametrize("logn,c", [(4, 0), (10, 0), (13, 0), (14, 0), (15, 1), (10, 2), (12, 3)],
                         ids=["logn4-c0", "logn10-c0", "logn13-c0", "logn14-c0", "logn15-c1",
                              "logn10-c2", "logn12-c3"])
def test_kernel_pass_model_matches_plain(logn, c):
    """The kernel's form (one block; clusters of 2, 4 and 8 blocks on small
    rings, where the chunk is shorter than the last round's reach of the
    padding) against the plain butterfly, forward and inverse, with delayed
    reductions (primes below 2^30) and without (31-bit primes)."""
    _check_model(logn, c, bits=30)
    _check_model(logn, c, bits=31)


def test_kernel_pass_model_ring_2_17():
    """A ring-2^17 plane on the cluster the card runs it on, one limb."""
    assert bf_ntt.cluster_log(17) == 3
    _check_model(17, 3, bits=28, limbs=1)


@pytest.mark.parametrize("bits", [30, 31])
@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("logn", [14, 15, 16, 17])
def test_cluster_model_matches_plain(logn, c, bits):
    """Clusters of 2, 4 and 8 blocks on rings 2^14 to 2^17.  The index
    arithmetic holds for any chunk; the kernel itself takes chunks up to 2^14."""
    assert (c in _valid_clusters(logn)) == (logn - c <= bf_ntt.LOG_CHUNK)
    _check_model(logn, c, bits=bits, limbs=1)


def test_packed_twiddles_are_the_tables_with_shoup_quotients():
    n = 1 << 10
    ps = tprimes.ntt_primes(n, 31, 2)
    t = tntt.build_device_tables(ps, n, "cpu")
    for pack, plain in ((t.psi_pack, t.psi_rev), (t.ipsi_pack, t.ipsi_rev)):
        u = pack.numpy().view(np.uint64)
        np.testing.assert_array_equal((u & M32).astype(np.int64), plain.numpy())
        for li, p in enumerate(ps):
            want = [(int(w) << 32) // p for w in plain[li].tolist()]
            np.testing.assert_array_equal(u[li] >> np.uint64(32), np.array(want, dtype=np.uint64))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    n = 64
    ps = tprimes.ntt_primes(n, 28, 2)
    t = tntt.build_device_tables(ps, n, "cpu")
    x = torch.zeros(1, 2, n, dtype=torch.int64)
    limbs = torch.arange(2)
    bf_ntt._check(x, t, limbs)
    with pytest.raises(ValueError):
        bf_ntt._check(x.to(torch.int32), t, limbs)
    with pytest.raises(ValueError):
        bf_ntt._check(x.transpose(1, 2), t, limbs)
    with pytest.raises(ValueError):
        bf_ntt._check(torch.zeros(1, 2, 2 * n, dtype=torch.int64), t, limbs)
    with pytest.raises(ValueError):
        bf_ntt._check(x, t, torch.arange(3))


def test_default_device_is_the_card():
    """Entry points run on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    params = CkksParams(ring_n=64, mult_depth=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Context(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tntt.build_device_tables(tprimes.ntt_primes(64, 28, 1), 64)
    assert Context(params, device="cpu").device.type == "cpu"
