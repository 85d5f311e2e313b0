"""K4, the key switch's RNS base extension (`core/rns_bconv.py`).

On the CPU: the plain version, which CPU tensors run, against the
evaluator's expressions it replaced (`mulmod` by the hat-inverse, then
`mod_matmul` a digit, stacked), bit for bit, for ModUp and ModDown at every
level, short last digits and residues p - 1 included, and for a limb rank's
rows (`Context.ks_rows(level, parts, index)`: the rank's own rows multiplied
before the gather, as the evaluator did, against every gathered row
multiplied inside the extension, as it does now); a transcription of the
kernel's arithmetic (Shoup's product, a fold every four terms, the final
reduction), in exact integers with every accumulator held inside u64,
against the plain version, on wide digits and on extreme primes and
residues; zero target rows.

On the card (marked `cuda`; skipped without a CUDA device): the kernel
against the plain version at every level's shapes of the three benchmark
configurations, on strided views and a digit too wide for 48 KB of shared
memory; zero target rows launch nothing; ModUp and ModDown of an evaluator
on the card against the CPU evaluator; one launch a call, eagerly and in a
replayed CUDA graph."""

import functools

import numpy as np
import pytest
import torch

from fhe_sorting_tpu_torch.core import cuda_build, primes, rns_bconv
from fhe_sorting_tpu_torch.core.context import CkksParams, Context, cyclic
from fhe_sorting_tpu_torch.core.modmath import mulmod
from fhe_sorting_tpu_torch.core.ntt_mxu import mod_matmul

torch.set_num_threads(2)

# (ranks of the limb axis, this rank's index): every row, and limb ranks' rows
PARTS = [(1, 0), (2, 0), (2, 1), (3, 2)]


@functools.lru_cache(maxsize=None)
def _ctx(dnum: int) -> Context:
    """The cells' kind of chain (prime pairs for a 2^56 scale), shallow:
    Lq 12, K 4 at dnum 3 (digits of 4, a short last one at odd levels),
    K 12 at dnum 1 (one digit of 12 rows: three of the kernel's chunks)."""
    return Context(CkksParams(ring_n=256, mult_depth=4, scale_bits=56, comp=2, base_limbs=4,
                              dnum=dnum), device="cpu")


def _residues(gen, shape, p):
    """Residues mod the rows' primes p [r, 1] (rows on axis -2), with p - 1
    in every row's first column and 0 in its second."""
    x = torch.remainder(torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64,
                                      device=p.device), p)
    x[..., 0] = p[:, 0] - 1
    x[..., 1] = 0
    return x


def _own_rows(ctx, level, parts, index):
    """(this rank's active rows, its special rows) as global row lists."""
    return list(cyclic(ctx.limbs_at(level), parts, index)), list(cyclic(ctx.num_sp, parts, index))


# -- the plain version against the expressions it replaced -------------------

def _old_modup(ctx, level, part, x_whole):
    """The evaluator's ModUp before K4, after its INTT: each rank's own rows
    times their dhat_inv, gathered (here: every rank's product in global
    order), then one `mod_matmul` a digit into its target rows, stacked."""
    parts, _ = part
    plan = ctx.ks_plans[level]
    rows = ctx.ks_rows(level, *part)
    y = torch.empty_like(x_whole)
    for idx in range(parts):
        own = list(cyclic(ctx.limbs_at(level), parts, idx))
        r = ctx.ks_rows(level, parts, idx)
        assert torch.equal(r.p_active, ctx.p_active(level)[own])
        y[own] = mulmod(x_whole[own], plan.dhat_inv[own], r.p_active)
    q, sp = _own_rows(ctx, level, *part)
    own = [*q, *(ctx.limbs_at(level) + j for j in sp)]
    return torch.stack([mod_matmul(fac[own], y[lo:hi], rows.p_target)
                        for fac, (lo, hi) in zip(plan.dig_ext, ctx.digit_layout(level))])


def _old_moddown(ctx, level, part, cp_whole):
    """The evaluator's ModDown extension before K4: each rank's special rows
    times their phat_inv, gathered, then `mod_matmul` by its rows of pext."""
    parts, _ = part
    plan = ctx.ks_plans[level]
    rows = ctx.ks_rows(level, *part)
    y = torch.empty_like(cp_whole)
    for idx in range(parts):
        own = list(cyclic(ctx.num_sp, parts, idx))
        r = ctx.ks_rows(level, parts, idx)
        y[:, own] = mulmod(cp_whole[:, own], plan.phat_inv[own], r.p_special)
    return mod_matmul(rows.pext, y, rows.p_active)


@pytest.mark.parametrize("dnum", [3, 1])
@pytest.mark.parametrize("part", PARTS)
def test_plain_version_is_the_old_expressions(dnum, part):
    """ModUp [1, Ll, n] -> [D, T, n] and ModDown [2, K, n] -> [2, a, n], as
    the evaluator calls `base_extend` (every gathered row, the whole
    hat-inverses and primes, the rank's rows of the factors), equal the
    expressions they replaced at every level, on every row and on limb
    ranks' rows."""
    ctx = _ctx(dnum)
    n = ctx.params.ring_n
    gen = torch.Generator().manual_seed(dnum * 10 + part[1])
    for level in range(ctx.params.mult_depth + 1):
        rows = ctx.ks_rows(level, *part)
        Ll, K = ctx.limbs_at(level), ctx.num_sp
        x = _residues(gen, (Ll, n), ctx.p_active(level))
        got = rns_bconv.base_extend(x[None], rows.dhat_inv, ctx.p_active(level), rows.dig_ext,
                                    rows.p_target, ctx.digit_layout(level))
        want = _old_modup(ctx, level, part, x)
        assert got.shape == (len(ctx.digit_layout(level)), rows.p_target.shape[0], n)
        assert torch.equal(got, want)
        cp = _residues(gen, (2, K, n), ctx.p_special())
        got = rns_bconv.base_extend(cp, rows.phat_inv, ctx.p_special(), rows.pext,
                                    rows.p_active, ((0, K),))
        assert got.shape == (2, rows.n_active, n)
        assert torch.equal(got, _old_moddown(ctx, level, part, cp))


def test_short_last_digit_and_the_layout():
    """The levels where the last digit is shorter than the others, and the
    factor matrix's columns: digit (lo, hi)'s factors are the plan's."""
    ctx = _ctx(3)
    short = [lvl for lvl in range(ctx.params.mult_depth + 1)
             if len({hi - lo for lo, hi in ctx.digit_layout(lvl)}) > 1]
    assert short
    for level in short:
        rows = ctx.ks_rows(level)
        for fac, (lo, hi) in zip(ctx.ks_plans[level].dig_ext, ctx.digit_layout(level)):
            assert torch.equal(rows.dig_ext[:, lo:hi], fac)


def test_zero_target_rows():
    """A limb rank that owns no target row gets empty planes of the right
    shape."""
    ctx = _ctx(3)
    level = ctx.params.mult_depth
    parts = ctx.limbs_at(level) + ctx.num_sp + 1
    rows = ctx.ks_rows(level, parts, parts - 1)
    assert rows.p_target.shape[0] == 0 and rows.n_active == 0
    n = ctx.params.ring_n
    x = _residues(torch.Generator().manual_seed(0), (1, ctx.limbs_at(level), n),
                  ctx.p_active(level))
    got = rns_bconv.base_extend(x, rows.dhat_inv, ctx.p_active(level), rows.dig_ext,
                                rows.p_target, ctx.digit_layout(level))
    assert got.shape == (len(ctx.digit_layout(level)), 0, n)


def test_unsupported_device_raises():
    """Neither the CPU nor a CUDA device: no plain fallback."""
    x = torch.empty(1, 3, 8, dtype=torch.int64, device="meta")
    p = torch.ones(3, 1, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rns_bconv.base_extend(x, p, p, torch.ones(2, 3, dtype=torch.int64, device="meta"),
                              p[:2], ((0, 3),))


# -- the kernel's arithmetic, transcribed in exact integers -------------------

_MASK = 0xFFFFFFFF
_CH = 4            # csrc/rns_bconv.cu CH: the terms summed between two folds


def _shoup_lazy(x, w, ws, p):
    """csrc/rns_bconv.cu `shoup_lazy` in u32: x w - umulhi(x, ws) p."""
    return (x * w - ((x * ws) >> 32) * p) & _MASK


def _once(r, p):
    return np.where(r >= p, r - p, r)


def _row_consts(p):
    """A target row's c = 2^32 mod p, c' and Barrett's m, as the kernel
    makes them."""
    c = (1 << 32) % p
    return c, (c << 32) // p, _MASK // p


def _fold(acc, p):
    c, cs, _ = _row_consts(p)
    return _shoup_lazy(acc >> 32, c, cs, p) + (acc & _MASK)


def _finish(acc, p):
    c, cs, m = _row_consts(p)
    return _once(_once(_shoup_lazy(acc >> 32, c, cs, p), p)
                 + _once(_shoup_lazy(acc & _MASK, 1, m, p), p), p)


def _kernel(x, hat, pin, fac, pout, digits):
    """csrc/rns_bconv.cu `rns_bconv_kernel` over whole planes, in Python
    integers (object arrays), each accumulator checked against the unsigned
    64-bit range the kernel holds it in."""
    B, _, n = x.shape
    T = fac.shape[0]
    out = np.zeros((B * len(digits), T, n), dtype=object)
    xo = x.astype(object)
    pin_o, hat_o = pin[:, 0].astype(object), hat[:, 0].astype(object)
    po = pout[:, 0].astype(object)[:, None]
    for b in range(B):
        for d, (lo, hi) in enumerate(digits):
            w = hi - lo
            p_i = pin_o[lo:hi, None]
            h = hat_o[lo:hi, None]
            y = _once(_shoup_lazy(xo[b, lo:hi], h, (h << 32) // p_i, p_i), p_i)
            f = fac[:, lo:hi].astype(object)
            acc = np.zeros((T, n), dtype=object)
            for c in range(0, w, _CH):
                acc = acc + f[:, c:c + _CH] @ y[c:c + _CH]
                assert all(0 <= v < 1 << 64 for v in acc.ravel())
                if c + _CH < w:
                    acc = _fold(acc, po)
                    assert all(v < 1 << 33 for v in acc.ravel())
            out[b * len(digits) + d] = _finish(acc, po)
    return out.astype(np.int64)


def _case(gen, B, R, T, n, in_primes, out_primes, edge=False):
    """(x, hat, pin, fac, pout) with canonical residues; `edge` makes every
    product the largest (hat 1, x and the factors p - 1)."""
    pin = torch.tensor(in_primes, dtype=torch.int64)[:, None]
    pout = torch.tensor(out_primes, dtype=torch.int64)[:, None]
    if edge:
        x = (pin - 1).expand(B, R, n).clone()
        return x, torch.ones_like(pin), pin, (pout - 1).expand(T, R).clone(), pout
    x = _residues(gen, (B, R, n), pin)
    hat = torch.remainder(torch.randint(0, 1 << 62, (R, 1), generator=gen), pin)
    fac = torch.remainder(torch.randint(0, 1 << 62, (T, R), generator=gen), pout)
    fac[:, 0] = pout[:, 0] - 1
    return x, hat, pin, fac, pout


@pytest.mark.parametrize("widths,bits", [
    ((24, 24, 24, 24), 28),     # mehp24_n512's digits
    ((23, 23, 22), 30),         # direct_n128's, a short last one
    ((1, 3, 4, 5, 9), 31),      # around the chunk of four, 31-bit primes
    ((40,), 31),                # ten chunks: nine folds
])
def test_kernel_arithmetic_matches_plain(widths, bits):
    """The kernel's sums, folds and final reduction give the plain version's
    residues for digits of every width around its chunk, with every
    accumulator inside u64."""
    R = sum(widths)
    digits, lo = [], 0
    for w in widths:
        digits.append((lo, lo + w))
        lo += w
    ps = primes.ntt_primes(256, bits, R + 9)
    gen = torch.Generator().manual_seed(R + bits)
    args = _case(gen, 2, R, 9, 16, ps[:R], ps[R:])
    got = _kernel(*(a.numpy() for a in args), digits)
    assert np.array_equal(got, rns_bconv.base_extend_plain(*args, digits).numpy())


@pytest.mark.parametrize("p_in,p_out", [
    (2147483647, 2147483629), (2147483629, 17), (17, 2147483647), (1073741827, 268369921)])
def test_kernel_arithmetic_on_extreme_primes(p_in, p_out):
    """Primes from the largest below 2^31 down to 17: the largest products
    over 40 terms (the accumulator's worst case), and random residues with
    p - 1 and 0, reduce to the plain version's residues."""
    gen = torch.Generator().manual_seed(p_in % 1000 + p_out % 1000)
    for edge in (True, False):
        args = _case(gen, 1, 40, 3, 8, [p_in] * 40, [p_out] * 3, edge=edge)
        got = _kernel(*(a.numpy() for a in args), [(0, 40)])
        assert np.array_equal(got, rns_bconv.base_extend_plain(*args, [(0, 40)]).numpy())
    assert _MASK // p_in == (1 << 32) // p_in


# -- on the card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("K4 is a CUDA kernel: needs a CUDA device")


# the benchmark's configurations: direct_n128, mehp24_n512, direct_hybrid_n512
CELL_PARAMS = [dict(mult_depth=32, dnum=3), dict(mult_depth=46, dnum=4),
               dict(mult_depth=48, dnum=5)]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELL_PARAMS, ids=["direct_n128", "mehp24_n512", "hybrid_n512"])
def test_k4_matches_plain_on_card(cell):
    """K4 against its plain version, bit for bit, at every level's ModUp and
    ModDown shapes of the configuration (ring 2^17), one launch each."""
    _card()
    ctx = Context(CkksParams(ring_n=1 << 17, scale_bits=56, comp=2, base_limbs=4,
                             ntt_impl="butterfly", **cell), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cell["mult_depth"])
    n, K = ctx.params.ring_n, ctx.num_sp
    for level in range(ctx.params.mult_depth + 1):
        rows = ctx.ks_rows(level)
        x = _residues(gen, (1, ctx.limbs_at(level), n), ctx.p_active(level))
        cp = _residues(gen, (2, K, n), ctx.p_special())
        for args in ((x, rows.dhat_inv, ctx.p_active(level), rows.dig_ext, rows.p_target,
                      ctx.digit_layout(level)),
                     (cp, rows.phat_inv, ctx.p_special(), rows.pext, rows.p_active, ((0, K),))):
            before = cuda_build.counts()
            got = rns_bconv.base_extend(*args)
            torch.cuda.synchronize()
            assert cuda_build.since(before) == {"k1": 0, "k2": 0, "k3": 0, "k4": 1}
            assert torch.equal(got, rns_bconv.base_extend_plain(*args)), level


@pytest.mark.cuda
def test_k4_views_wide_digits_and_zero_rows_on_card():
    """Strided views (a batch stride, rows 2n apart, strided constants), a
    digit of 64 rows (more than 48 KB of shared memory), widths that are no
    multiple of four, a small ring; zero target rows launch nothing; no
    fallback for what the kernel does not take."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    ps = primes.ntt_primes(1 << 12, 31, 140)
    for widths, n in (((64, 5), 1 << 12), ((23, 23, 22), 1 << 13), ((3,), 256)):
        R = sum(widths)
        digits, lo = [], 0
        for w in widths:
            digits.append((lo, lo + w))
            lo += w
        pin = torch.tensor(ps[:R], device="cuda")[:, None]
        pout = torch.tensor(ps[R:R + 50], device="cuda")[:, None]
        # rows 2n apart: the even rows of [3, 2R + 2, n] planes
        big = torch.zeros(3, 2 * R + 2, n, dtype=torch.int64, device="cuda")
        big[:, 0:2 * R:2] = _residues(gen, (3, R, n), pin)
        x = big[:2, 0:2 * R:2]
        assert x.stride(1) == 2 * n and not x.is_contiguous()
        consts = torch.cat([torch.remainder(torch.randint(0, 1 << 62, (R, 1), generator=gen,
                                                          device="cuda"), pin), pin], dim=1)
        hat, pin_v = consts[:, 0:1], consts[:, 1:2]
        fac = torch.remainder(torch.randint(0, 1 << 62, (50, R), generator=gen, device="cuda"),
                              pout)
        args = (x, hat, pin_v, fac, pout, digits)
        before = cuda_build.counts()
        got = rns_bconv.base_extend(*args)
        torch.cuda.synchronize()
        assert cuda_build.since(before) == {"k1": 0, "k2": 0, "k3": 0, "k4": 1}
        assert torch.equal(got, rns_bconv.base_extend_plain(*args)), (widths, n)
        empty = rns_bconv.base_extend(x, hat, pin_v, fac[:0], pout[:0], digits)
        assert empty.shape == (2 * len(widths), 0, n)
        assert cuda_build.since(before) == {"k1": 0, "k2": 0, "k3": 0, "k4": 1}
    with pytest.raises(ValueError):       # every other residue: no plain fallback
        rns_bconv.base_extend(x[..., ::2], hat, pin_v, fac, pout, digits)
    with pytest.raises(ValueError):
        rns_bconv.base_extend(x.to(torch.int32), hat, pin_v, fac, pout, digits)
    with pytest.raises(ValueError):       # digits that leave a gap
        rns_bconv.base_extend(x, hat, pin_v, fac, pout, [(0, 1), (2, 3)])


@pytest.mark.cuda
def test_k4_in_evaluator_and_graphs_on_card():
    """ModUp and ModDown of an evaluator on the card give the CPU evaluator's
    planes on the same inputs at every level, each through one K4 launch; a
    stage of two rotations on a CUDA graph replays to the eager planes, and
    its replay advances the launch counter's `k4` and its span's `k4` as
    the eager call did."""
    _card()
    from fhe_sorting_tpu_torch.core import trace
    from fhe_sorting_tpu_torch.core.cipher import Ciphertext
    from fhe_sorting_tpu_torch.core.evaluator import Evaluator
    from fhe_sorting_tpu_torch.core.keys import Keys
    from fhe_sorting_tpu_torch.parallel.whole_graph import WholeGraph

    params = CkksParams(ring_n=1 << 12, mult_depth=4, scale_bits=56, comp=2, base_limbs=4)
    evs = {}
    for dev in ("cpu", "cuda"):
        ctx = Context(params, device=dev)
        keys = Keys.generate(ctx, seed=0)
        keys.gen_rotation_keys([1, 2])
        evs[dev] = Evaluator(ctx, keys)
    ctx, n = evs["cpu"].ctx, params.ring_n
    rng = np.random.default_rng(0)
    ps = np.array(ctx.all_primes, dtype=np.int64)
    for level in range(params.mult_depth + 1):
        Ll = ctx.limbs_at(level)
        d = rng.integers(0, 1 << 62, (Ll, n)) % ps[:Ll, None]
        c = rng.integers(0, 1 << 62, (2, Ll + ctx.num_sp, n))
        c %= np.concatenate([ps[:Ll], ps[ctx.num_q:]])[:, None]
        got = {}
        for dev, ev in evs.items():
            before = cuda_build.counts()
            got[dev] = (ev._modup(torch.from_numpy(d).to(dev), level),
                        ev._moddown(torch.from_numpy(c).to(dev), level))
            torch.cuda.synchronize()
            assert cuda_build.since(before)["k4"] == (0 if dev == "cpu" else 2)
        for g_cpu, g_card in zip(got["cpu"], got["cuda"]):
            assert torch.equal(g_card.cpu(), g_cpu), level

    ev = evs["cuda"]
    Ll = ctx.limbs_at(1)
    data = rng.integers(0, 1 << 62, (2, Ll, n)) % ps[:Ll, None]
    ct = Ciphertext(torch.from_numpy(data).cuda(), 1, 1, n // 2)
    stage = WholeGraph(ev, lambda cts: ev.rotate(ev.rotate(cts[0], 1), 2), name="k4.rotations")
    before = cuda_build.counts()
    want = stage([ct])                                  # eager, then the capture
    torch.cuda.synchronize()
    assert cuda_build.since(before)["k4"] == 4          # the capture launched nothing
    launched = []
    with trace.recording():
        for _ in range(2):
            before = cuda_build.counts()
            out = stage([ct])                           # replays
            torch.cuda.synchronize()
            launched.append(cuda_build.since(before)["k4"])
            assert torch.equal(out.data, want.data)
    spans = [s for s in trace.spans() if s.name == "k4.rotations"]
    assert launched == [4, 4]
    assert [(s.counts["kind"], s.counts["k4"]) for s in spans] == [("replay", 4)] * 2
