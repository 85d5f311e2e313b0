"""K3, the exact division by a dropped modulus (`core/rns_div.py`), on the CPU.

The kernel itself needs the card (`tests/test_torch_kernels.py`, marked
`cuda`).  Here: the plain versions, which CPU tensors run, against the
evaluator's expressions they replaced, bit for bit; a numpy transcription of
the kernel's 32-bit arithmetic (Barrett's and Shoup's quotients, made from
the rows' primes and constants as each block makes them) against the plain
versions, on edge inputs, for whole and partial row sets and on extreme
primes; zero rows."""

import functools

import numpy as np
import pytest
import torch

from fhe_sorting_tpu_torch.core import rns_div
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.modmath import mulmod, sub_mod

torch.set_num_threads(2)

# (ranks of the limb axis, this rank's index): every row, and one rank's of two
PARTS = [(1, 0), (2, 1)]


@functools.lru_cache(maxsize=None)
def _ctx(ring: int) -> Context:
    """The cells' kind of chain (prime pairs for a 2^56 scale), shallow."""
    return Context(CkksParams(ring_n=ring, mult_depth=4, scale_bits=56, comp=2, base_limbs=4),
                   device="cpu")


def _old_lift(x, rows):
    """The evaluator's centred lift before K3."""
    xm = torch.remainder(x, rows.p)
    return torch.where(x >= rows.qlast_half, sub_mod(xm, rows.qlast_mod_qi, rows.p), xm)


def _old_div(a, b, p, w):
    """The evaluator's (a - b) w mod p before K3."""
    return mulmod(sub_mod(a, b, p), w, p)


def _coeffs(gen, B, n, q):
    """Coefficients of a dropped limb in [0, q), with the edges of the
    centring: 0, 1, ceil(q/2) - 1, ceil(q/2), q - 1."""
    x = torch.randint(0, q, (B, 1, n), generator=gen, dtype=torch.int64)
    half = (q + 1) // 2
    x[0, 0, :5] = torch.tensor([0, 1, half - 1, half, q - 1])
    x[-1, 0, -2:] = torch.tensor([half, half - 1])
    return x


def _residues(gen, shape, p):
    """Residues mod the rows' primes p [r, 1], with 0 and p - 1 in each row."""
    x = torch.remainder(torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64), p)
    x[..., 0] = 0
    x[..., 1] = p[:, 0] - 1
    return x


def _drop(ctx, drop, part):
    """(rescale rows, q_last) of the `drop`-th dropped limb."""
    return ctx.rescale_rows(drop, *part), ctx.q_primes[ctx.num_q - drop - 1]


# -- the plain versions against the expressions they replaced -----------------

def test_plain_versions_are_the_old_expressions():
    """One case for what is a copy: a rescale's two halves for the top and a
    deep dropped limb, `a` a [:, :r] view of larger planes, and ModDown's last
    step on c[..., :a, :] at the top and the bottom level, at ring 256 and
    4096, B = 1 and 2, on every row and on one limb rank's rows.  The
    evaluator's use of them is held to the JAX package by its parity tests."""
    for ring in (256, 4096):
        ctx = _ctx(ring)
        gen = torch.Generator().manual_seed(ring)
        for part in PARTS:
            for B in (1, 2):
                for drop in (0, ctx.params.comp * ctx.params.mult_depth - 1):
                    rows, q = _drop(ctx, drop, part)
                    r = rows.p.shape[0]
                    x = _coeffs(gen, B, ring, q)
                    t = rns_div.lift(x, rows.p, rows.qlast_mod_qi, rows.qlast_half)
                    assert t.shape == (B, r, ring)
                    assert torch.equal(t, _old_lift(x, rows))
                    planes = torch.cat([_residues(gen, (B, r, ring), rows.p),
                                        torch.zeros(B, 1, ring, dtype=torch.int64)], dim=1)
                    a, b = planes[:, :r], _residues(gen, (B, r, ring), rows.p)
                    got = rns_div.sub_scale(a, b, rows.p, rows.qlast_inv)
                    assert torch.equal(got, _old_div(a, b, rows.p, rows.qlast_inv))
            for level in (0, ctx.params.mult_depth):
                rows = ctx.ks_rows(level, *part)
                a = rows.n_active
                c = torch.cat([_residues(gen, (2, a, ring), rows.p_active),
                               _residues(gen, (2, rows.p_special.shape[0], ring),
                                         rows.p_special)], dim=1)
                ext = _residues(gen, (2, a, ring), rows.p_active)
                got = rns_div.sub_scale(c[..., :a, :], ext, rows.p_active, rows.p_inv_mod_qi)
                assert torch.equal(got, _old_div(c[..., :a, :], ext, rows.p_active,
                                                 rows.p_inv_mod_qi))


# -- the kernel's arithmetic, transcribed to numpy ----------------------------

_MASK = np.uint64(0xFFFFFFFF)


def _u32(v) -> np.ndarray:
    """Integers as u32 values held in u64 (the kernel's casts from int64)."""
    return np.asarray(v, dtype=np.int64).astype(np.uint64) & _MASK


def _shoup(x, w, ws, p):
    """csrc/rns_div.cu `shoup` in u32: x w - umulhi(x, ws) p, less p once."""
    r = (x * w - ((x * ws) >> np.uint64(32)) * p) & _MASK
    return np.where(r >= p, r - p, r)


def _kernel_lift(x, p, c, half: int) -> np.ndarray:
    """csrc/rns_div.cu `rns_lift_kernel` over x [B, 1, n] and the rows' p
    and c [r, 1]: a block's m = (2^32 - 1) / p, then `lift1`."""
    p, c = _u32(p), _u32(c)
    m = np.uint64(0xFFFFFFFF) // p
    xu = _u32(x)
    t = _shoup(xu, np.uint64(1), m, p)
    lifted = np.where(t >= c, t - c, t + p - c)
    return np.where(xu < np.uint64(half), t, lifted).astype(np.int64)


def _kernel_sub_scale(a, b, p, w) -> np.ndarray:
    """csrc/rns_div.cu `rns_sub_scale_kernel` over a, b [B, r, n] and the
    rows' p and w [r, 1]: a block's ws = (w << 32) / p, then `sub_scale1`."""
    p, w = _u32(p), _u32(w)
    ws = (w << np.uint64(32)) // p
    u, v = _u32(a), _u32(b)
    d = np.where(u >= v, u - v, u + p - v)
    return _shoup(d, w, ws, p).astype(np.int64)


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("ring", [256, 4096])
def test_kernel_arithmetic_matches_plain(ring, part):
    """The kernel's Barrett lift and Shoup division, with the quotients made
    from the rows' primes and constants, give the plain versions' residues
    for every dropped limb and every level's ModDown, edge inputs
    included."""
    ctx = _ctx(ring)
    gen = torch.Generator().manual_seed(3 * ring)
    for drop in range(ctx.params.comp * ctx.params.mult_depth):
        rows, q = _drop(ctx, drop, part)
        r = rows.p.shape[0]
        x = _coeffs(gen, 2, ring, q)
        got = _kernel_lift(x.numpy(), rows.p.numpy(), rows.qlast_mod_qi.numpy(), rows.qlast_half)
        assert np.array_equal(got, rns_div.lift_plain(x, rows.p, rows.qlast_mod_qi,
                                                      rows.qlast_half).numpy())
        a, b = (_residues(gen, (2, r, ring), rows.p) for _ in range(2))
        b[:, :, 0] = rows.p[:, 0] - 1          # 0 - (p - 1): the widest wrap
        got = _kernel_sub_scale(a.numpy(), b.numpy(), rows.p.numpy(), rows.qlast_inv.numpy())
        assert np.array_equal(got, rns_div.sub_scale_plain(a, b, rows.p, rows.qlast_inv).numpy())
    for level in range(ctx.params.mult_depth + 1):
        rows = ctx.ks_rows(level, *part)
        a, b = (_residues(gen, (2, rows.n_active, ring), rows.p_active) for _ in range(2))
        got = _kernel_sub_scale(a.numpy(), b.numpy(), rows.p_active.numpy(),
                                rows.p_inv_mod_qi.numpy())
        assert np.array_equal(got, rns_div.sub_scale_plain(a, b, rows.p_active,
                                                           rows.p_inv_mod_qi).numpy())


@pytest.mark.parametrize("p", [2147483647, 2147483629, 1073741827, 268369921, 786433, 17])
def test_kernel_quotients_on_extreme_primes(p):
    """The kernel's quotients and products at primes from the largest below
    2^31 down to 17: (2^32 - 1) // p is floor(2^32 / p) for an odd p, and the
    Barrett lift and the Shoup division are exact on edge coefficients (up to
    2^31 - 1, the widest a dropped prime below 2^31 gives), residues and
    multipliers."""
    assert 0xFFFFFFFF // p == (1 << 32) // p
    xs = np.array([0, 1, p - 1, p, p + 1, 2 * p - 1, (1 << 31) - 2, (1 << 31) - 1], np.int64)
    for q in (p, (1 << 31) - 1):
        x = xs[xs < q][None, None, :]
        c, half = q % p, (q + 1) // 2
        xm = x % p
        want = np.where(x >= half, (xm - c) % p, xm)
        assert np.array_equal(_kernel_lift(x, [[p]], [[c]], half), want)
    res = np.array([0, 1, p - 2, p - 1], np.int64)
    a, b = np.meshgrid(res, res)
    for w in (0, 1, p // 2, p - 1):
        want = np.array([(int(u) - int(v)) % p * w % p for u, v in zip(a.ravel(), b.ravel())])
        got = _kernel_sub_scale(a[None], b[None], [[p]], [[w]])
        assert np.array_equal(got.ravel(), want)


def test_zero_rows():
    """A limb rank that owns no kept row gets empty planes of the right shape."""
    ctx = _ctx(256)
    drop = ctx.params.comp * ctx.params.mult_depth - 1
    parts = ctx.num_q                  # more ranks than the deepest rescale keeps rows
    rows = ctx.rescale_rows(drop, parts, parts - 1)
    assert rows.p.shape[0] == 0
    x = _coeffs(torch.Generator().manual_seed(0), 2, 256, _drop(ctx, drop, (1, 0))[1])
    t = rns_div.lift(x, rows.p, rows.qlast_mod_qi, rows.qlast_half)
    assert t.shape == (2, 0, 256)
    got = rns_div.sub_scale(t, t, rows.p, rows.qlast_inv)
    assert got.shape == (2, 0, 256)


def test_unsupported_device_raises():
    """Neither the CPU nor a CUDA device: no plain fallback."""
    x = torch.empty(2, 1, 8, dtype=torch.int64, device="meta")
    p = torch.ones(3, 1, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rns_div.lift(x, p, p, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        rns_div.sub_scale(x, x, p, p)
