"""K2's function (the merged-twiddle butterfly NTT) in the port against the JAX
package, and the pass structure of the CUDA kernel against the plain version.

Same inputs (numpy, seeded) through both packages; every comparison is
bit-exact (tolerance 0), since all of them compute canonical residues mod p.
The JAX side runs both its XLA butterfly and the Pallas kernel K2 in
interpret mode.  The CUDA kernel itself cannot run without a card
(tests/test_torch_kernels.py holds it against the plain version there); what
runs here is `_model_pass`, a numpy transcription of the kernel's index
arithmetic (`csrc/bf_ntt.cu`), driven by the wrapper's own pass plan."""

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


@pytest.mark.parametrize("logn", range(1, 22))
def test_pass_plan_covers_every_stage_once(logn):
    plan = bf_ntt.passes(logn)
    assert plan[0][0] == 0 and plan[-1][1] == logn
    for (s0, s1, log_t), nxt in zip(plan, plan[1:] + [None]):
        assert s0 < s1 and 0 <= log_t <= logn - s1
        assert 1 <= (s1 - s0) + log_t <= bf_ntt.LOG_TILE      # the kernel's tile limit
        if nxt is not None:
            assert nxt[0] == s1
    assert plan[-1][2] == 0
    if logn <= bf_ntt.LOG_TILE:
        assert len(plan) == 1
    if logn == 17:
        assert len(plan) == 2


def _model_pass(x, tw, p, ninv, logn, s0, s1, log_t, inverse, scale):
    """One kernel pass on one plane x [n] (u64), block by block, with the
    kernel's index arithmetic."""
    log_a, logcols = s1 - s0, logn - s1
    logtile, logtpo = log_a + log_t, logcols - log_t
    tile = 1 << logtile
    out = x.copy()
    e = np.arange(tile)
    k = np.arange(tile >> 1)
    for q in range(1 << (logn - logtile)):
        o, c0 = q >> logtpo, (q & ((1 << logtpo) - 1)) << log_t
        addr = (o << (log_a + logcols)) + c0 + ((e >> log_t) << logcols) + (e & ((1 << log_t) - 1))
        sm = x[addr].copy()
        for st in range(log_a):
            s = s1 - 1 - st if inverse else s0 + st
            lgh = (s1 - s - 1) + log_t
            grp = k >> lgh
            lo = (grp << (lgh + 1)) | (k & ((1 << lgh) - 1))
            hi = lo + (1 << lgh)
            w = tw[(1 << s) + (o << (s - s0)) + grp]
            u, v = sm[lo], sm[hi]
            if not inverse:
                vw = v * w % p
                sm[lo], sm[hi] = (u + vw) % p, (u + p - vw) % p
            else:
                sm[lo], sm[hi] = (u + v) % p, (u + p - v) % p * w % p
        out[addr] = sm * ninv % p if scale else sm
    return out


def _model_transform(x, t, limb, inverse):
    n = x.shape[0]
    logn = n.bit_length() - 1
    plan = bf_ntt.passes(logn)[::-1] if inverse else bf_ntt.passes(logn)
    tw = (t.ipsi_rev if inverse else t.psi_rev)[limb].numpy().astype(np.uint64)
    p, ninv = np.uint64(int(t.p[limb])), np.uint64(int(t.n_inv[limb]))
    for i, (s0, s1, log_t) in enumerate(plan):
        x = _model_pass(x, tw, p, ninv, logn, s0, s1, log_t, inverse,
                        inverse and i == len(plan) - 1)
    return x


@pytest.mark.parametrize("logn,tile", [(4, None), (10, None), (13, None), (14, None), (15, None),
                                       (10, (6, 4, 3)), (12, (5, 3, 2))])
def test_kernel_pass_model_matches_plain(logn, tile, monkeypatch):
    """The kernel's passes (one launch, two launches, and - with the tile
    limits shrunk - three and more strided passes) against the plain
    butterfly, forward and inverse."""
    if tile is not None:
        for name, v in zip(("LOG_TILE", "LOG_CONTIG", "LOG_ROWS"), tile):
            monkeypatch.setattr(bf_ntt, name, v)
        assert len(bf_ntt.passes(logn)) >= 3
    n = 1 << logn
    ps = tprimes.ntt_primes(n, 30, 2)
    t = tntt.build_device_tables(ps, n, "cpu")
    a = _residues(np.random.default_rng(logn), ps, (n,))          # [2, n]
    fwd = tntt.butterfly_plain(_t(a)[None], t, None, False)[0]
    inv = tntt.butterfly_plain(fwd[None], t, None, True)[0]
    for limb in range(2):
        got = _model_transform(a[limb], t, limb, False)
        np.testing.assert_array_equal(got.astype(np.int64), fwd[limb].numpy())
        back = _model_transform(got, t, limb, True)
        np.testing.assert_array_equal(back.astype(np.int64), inv[limb].numpy())
        np.testing.assert_array_equal(back, a[limb])


def test_kernel_pass_model_ring_2_17():
    """The two launches of a ring-2^17 plane, one limb."""
    n = 1 << 17
    ps = tprimes.ntt_primes(n, 28, 1)
    t = tntt.build_device_tables(ps, n, "cpu")
    a = _residues(np.random.default_rng(17), ps, (n,))
    fwd = tntt.butterfly_plain(_t(a)[None], t, None, False)[0]
    got = _model_transform(a[0], t, 0, False)
    np.testing.assert_array_equal(got.astype(np.int64), fwd[0].numpy())
    np.testing.assert_array_equal(_model_transform(got, t, 0, True), a[0])


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
