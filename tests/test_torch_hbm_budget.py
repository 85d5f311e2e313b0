"""The port's static device-memory accounting against real tensors of the
port: a key and a ciphertext take exactly the bytes it reckons (int64
planes), and a phase over budget raises before anything is allocated.  Also
what the accounting assumes: a Chebyshev evaluation frees its temporaries
when it returns, without waiting for the cyclic collector."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.utils import hbm_budget as hb

torch.set_num_threads(2)

PARAMS = {
    "comp1": dict(ring_n=256, mult_depth=5),
    "short": dict(ring_n=256, mult_depth=2),          # fewer digits than dnum
    "comp2": dict(ring_n=512, mult_depth=4, scale_bits=56, comp=2, base_limbs=4, dnum=2),
}


@pytest.fixture(scope="module", params=sorted(PARAMS))
def env(request):
    ctx = Context(CkksParams(**PARAMS[request.param]), device="cpu")
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys([1])
    return ctx, keys


def _nbytes(t):
    return t.numel() * t.element_size()


def test_ksk_bytes_is_a_real_key(env):
    ctx, keys = env
    for ksk in [keys.relin, *keys.rot.values()]:
        assert hb.ksk_bytes(ctx) == _nbytes(ksk.kb) + _nbytes(ksk.ka)


def test_ct_bytes_is_a_real_ciphertext(env):
    ctx, keys = env
    for level in (0, 1, ctx.params.mult_depth):
        ct = keys.encrypt(np.arange(4) / 4.0, level=level, seed=1)
        assert hb.ct_bytes(ctx, level) == _nbytes(ct.data)
    assert hb.RESIDUE_BYTES == keys.relin.kb.element_size() == 8


def test_phase_bytes_adds_up(env):
    ctx, _ = env
    k, c = hb.ksk_bytes(ctx), hb.ct_bytes(ctx, 0)
    assert hb.phase_bytes(ctx, 3, 2) == 4 * k + 6 * c
    assert hb.phase_bytes(ctx, 3, 2, relin=False, work_cts=0) == 3 * k + 2 * c


def test_check_phase_report_and_raise(env):
    ctx, _ = env
    used = hb.phase_bytes(ctx, 5, 2)
    fits_gb = used / (1 << 30) / (1 - hb.DEFAULT_HEADROOM_FRAC)
    rep = hb.check_phase(ctx, 5, 2, capacity_gb=fits_gb * 1.01, label="ok")
    assert rep["fits"] and rep["n_rot_keys"] == 5 and rep["label"] == "ok"
    assert rep["ksk_mib"] == round(hb.ksk_bytes(ctx) / (1 << 20), 1)
    with pytest.raises(MemoryError, match="tight needs"):
        hb.check_phase(ctx, 5, 2, capacity_gb=fits_gb * 0.99, label="tight")
    # the headroom is part of the budget
    with pytest.raises(MemoryError):
        hb.check_phase(ctx, 5, 2, capacity_gb=fits_gb * 1.01, headroom_frac=0.5)


def test_affine_tables_reckoned(env):
    """With the affine automorphism on, a phase also holds the path's tables,
    exactly the bytes `Context.auto_tables` makes, and its products' working
    set; off, nothing changes."""
    ctx, _ = env
    tables = ctx.auto_tables()
    assert hb.affine_table_bytes(ctx) == tables.nbytes()
    extra = hb.affine_table_bytes(ctx) + hb.WORK_CTS["affine"] * hb.ct_bytes(ctx, 0)
    assert hb.phase_bytes(ctx, 3, 2, affine=True) == hb.phase_bytes(ctx, 3, 2) + extra
    fits_gb = hb.phase_bytes(ctx, 3, 2) / (1 << 30) / (1 - hb.DEFAULT_HEADROOM_FRAC) * 1.001
    rep = hb.check_phase(ctx, 3, 2, capacity_gb=fits_gb)
    assert rep["affine_gib"] == 0
    with pytest.raises(MemoryError):
        hb.check_phase(ctx, 3, 2, affine=True, capacity_gb=fits_gb)


def test_four_step_tables_reckoned():
    """A four-step (K1) context's tables are counted in every phase, exactly
    their int64 bytes here (the kernel's copy exists on the card only); a
    butterfly context's lie in the fitted working sets."""
    params = dict(ring_n=256, mult_depth=2)
    bf = Context(CkksParams(**params), device="cpu")
    fs = Context(CkksParams(**params, ntt_impl="mxu"), device="cpu")
    assert hb.ntt_table_bytes(bf) == 0 and fs.tables.kern is None
    n1 = n2 = 16
    limbs = fs.num_q + fs.num_sp
    assert hb.ntt_table_bytes(fs) == limbs * (1 + 2 * n1 * n1 + 2 * n2 * n2 + 4 * n1 * n2) * 8
    assert hb.phase_bytes(fs, 3, 2) == hb.phase_bytes(bf, 3, 2) + hb.ntt_table_bytes(fs)
    rep = hb.check_phase(fs, 3, 2, capacity_gb=1.0)
    assert rep["ntt_tables_gib"] == round(hb.ntt_table_bytes(fs) / (1 << 30), 2)


def test_cpu_context_has_no_capacity_to_read(env):
    ctx, _ = env
    with pytest.raises(ValueError, match="capacity_gb"):
        hb.check_phase(ctx, 1, 1)
    with pytest.raises(ValueError):
        hb.device_capacity_gb(ctx)


def test_chebyshev_ps_frees_its_temporaries_without_gc():
    """`ChebyshevPS.evaluate` holds no reference cycle: with the cyclic
    collector off, every leaf it made is freed once the result is dropped (at
    N=1024, ring 2^17 the leaves of one sinc evaluation are 4.7 GB)."""
    import gc
    import weakref

    from fhe_sorting_tpu_torch.core.evaluator import Evaluator
    from fhe_sorting_tpu_torch.ops.chebyshev import ChebyshevPS, chebyshev_fit

    ctx = Context(CkksParams(ring_n=256, mult_depth=5), device="cpu")
    keys = Keys.generate(ctx, seed=0)
    ev = Evaluator(ctx, keys)
    refs = []
    combo = ev.combo

    def spy(cts, rows, consts):
        out = combo(cts, rows, consts)
        refs.extend(weakref.ref(c.data) for c in out)
        return out

    ev.combo = spy
    x = keys.encrypt(np.linspace(-0.9, 0.9, 8), seed=1)
    gc.collect()
    gc.disable()
    try:
        out = ChebyshevPS(ev).evaluate(x, chebyshev_fit(np.tanh, 7))
        assert refs and np.all(np.isfinite(keys.decrypt(out, 8)))
        del out
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def _chain(num_q: int, num_sp: int, dnum: int, ring: int = 1 << 17):
    """The sizes of a comp=2 chain that the reckoning reads, without its
    tables: a ring-2^17 context is too large to build here."""
    import types

    return types.SimpleNamespace(params=types.SimpleNamespace(ring_n=ring), num_q=num_q,
                                 num_sp=num_sp, tables=None,
                                 digit_layout=lambda level: [None] * dnum,
                                 limbs_at=lambda level: num_q - 2 * level)


@pytest.mark.parametrize("term,chain,keys,n_cts,peak", [
    ("direct_sharded", (86, 29, 3), 36, 4, 45.40),
    ("direct_sharded_graphs", (86, 29, 3), 36, 4, 51.98),
    ("mehp24_sharded", (96, 24, 4), 47, 12, 51.24),
    ("mehp24_sharded_graphs", (96, 24, 4), 47, 12, 53.22)])
def test_sharded_terms_cover_their_measured_peaks(term, chain, keys, n_cts, peak):
    """The four sharded working sets, refitted to the peaks `chip_smoke.py`
    phase 13 measured (sharded DirectSort N=1024: 20 rotation + 16 offset
    keys on Lq 86, K 29; sharded MEHP24 N=512: 47 rotation keys on Lq 96,
    K 24, dnum 4): each reckoning covers its peak, by less than one
    ciphertext more than it needs."""
    ctx = _chain(*chain)
    used = hb.phase_bytes(ctx, keys, n_cts, work_cts=hb.WORK_CTS[term]) / (1 << 30)
    short = hb.phase_bytes(ctx, keys, n_cts, work_cts=hb.WORK_CTS[term] - 1) / (1 << 30)
    assert short < peak + 0.005 <= used


@pytest.mark.parametrize("ranks", [2, 3])
def test_limb_rank_reckoned_at_its_share(env, ranks):
    """A rank of a limb axis is reckoned at the largest share of rows, of a
    key exactly what rank 0's rows of a real key take (`Keys.rows`), of a
    ciphertext its rows at level 0, plus the whole coefficient planes a key
    switch gathers; the ranks of the axis are reckoned together on one card,
    and each rank's peak against its share of the budget."""
    from fhe_sorting_tpu_torch.parallel.mesh import LimbLayout

    ctx, keys = env
    rows = LimbLayout(ctx.num_q, ctx.num_sp, ranks, 0).key_rows()
    own = Keys.generate(ctx, seed=0, rows=rows)
    assert hb.ksk_bytes(ctx, ranks) == _nbytes(own.relin.kb) + _nbytes(own.relin.ka)
    assert hb.ksk_bytes(ctx, ranks) < hb.ksk_bytes(ctx)
    ct = keys.encrypt(np.arange(4) / 4.0, seed=1)
    assert hb.ct_bytes(ctx, 0, ranks) == _nbytes(ct.data[:, 0::ranks])
    gathered = (ctx.num_q + 2 * ctx.num_sp) * ctx.params.ring_n * 8
    assert hb.gathered_bytes(ctx, ranks) == gathered and hb.gathered_bytes(ctx, 1) == 0
    k, c = hb.ksk_bytes(ctx, ranks), hb.ct_bytes(ctx, 0, ranks)
    assert hb.phase_bytes(ctx, 3, 2, limb_ranks=ranks) == 4 * k + 6 * c + gathered
    rank_gb = hb.phase_bytes(ctx, 3, 2, limb_ranks=ranks) / (1 << 30)
    fits_gb = ranks * rank_gb / (1 - hb.DEFAULT_HEADROOM_FRAC) * 1.001
    rep = hb.check_phase(ctx, 3, 2, limb_ranks=ranks, capacity_gb=fits_gb)
    assert rep["fits"] and rep["rank_bytes"] == hb.phase_bytes(ctx, 3, 2, limb_ranks=ranks)
    assert rep["limb_ranks"] == ranks and rep["used_gib"] == round(ranks * rank_gb, 2)
    with pytest.raises(MemoryError):
        hb.check_phase(ctx, 3, 2, limb_ranks=ranks, capacity_gb=fits_gb / 1.002)
    # each rank's peak against its share of the card's budget (8 GiB of 10)
    rep = hb.check_phase(ctx, 3, 2, limb_ranks=ranks, capacity_gb=10.0)
    rep["rank_bytes"] = 5 << 30               # a reckoning that leaves the budget to bind
    hb.check_peak(rep, 8.0 / ranks - 0.01)
    with pytest.raises(MemoryError, match="budget"):
        hb.check_peak(rep, 8.0 / ranks + 0.01)


def test_check_peak_fails_above_the_reckoning(env):
    """A peak within the budget but above what `check_phase` reckoned fails
    too: such a reckoning would not catch an oversized phase before it
    allocates."""
    ctx, _ = env
    rep = hb.check_phase(ctx, 3, 2, capacity_gb=10.0, label="tight")
    reckoned = hb.phase_bytes(ctx, 3, 2) / (1 << 30)
    hb.check_peak(rep, reckoned)
    with pytest.raises(MemoryError, match="tight: .* exceeds the .* reckoned"):
        hb.check_peak(rep, reckoned * 1.01 + 1e-6)
    assert reckoned * 1.01 + 1e-6 < rep["budget_gib"]
    # what was allocated before the phase counts against the budget, not
    # against the phase's reckoning
    hb.check_peak(rep, reckoned + 1.0, outside_gib=1.0)
    with pytest.raises(MemoryError, match="budget"):
        hb.check_peak(rep, rep["budget_gib"] + 0.01, outside_gib=rep["budget_gib"])


@pytest.mark.parametrize("ring,chain,keys,peak", [
    (1 << 17, (68, 23, 3), 9, 15.68),
    (1 << 12, (66, 22, 3), 8, 0.53)], ids=["ring2^17", "ring2^12"])
def test_scan_reckoning_covers_both_rings(ring, chain, keys, peak):
    """ScanDirectSort on graphs, `chip_smoke.py` phase 14's two sorts (N=128
    at ring 2^17, N=64 at ring 2^12, each peak less what was allocated
    before its context): its ciphertext term fitted at ring 2^17 and its
    fixed cost together cover both; at ring 2^12 the ciphertext term alone
    falls short."""
    ctx = _chain(*chain, ring=ring)
    work = hb.WORK_CTS["direct_scan_graphs"]
    used = hb.phase_bytes(ctx, keys, 4, work_cts=work,
                          fixed_mib=hb.FIXED_MIB["direct_scan_graphs"]) / (1 << 30)
    assert peak + 0.005 <= used
    if ring == 1 << 12:
        assert hb.phase_bytes(ctx, keys, 4, work_cts=work) / (1 << 30) < peak
