"""The port's k-way sorting network against the JAX package's on shared keys,
ring 512, depth 36, CompositeSign(3,1,1): the masking topology, the EvalUtils
helpers, whole sorts at k=3 (N=3) and k=5 (N=5), single stages of k=5, M=2
(the mixed 2345, two-plus-three and four-sorter stages) and the adapter.
Limb planes bit-equal (tolerance 0); decrypted sorts within 0.01 of
`np.sort`, the reference tests' bound."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu.models.kway import KWaySorter as JKWaySorter
from fhe_sorting_tpu.models.kway import adapter as jadapter
from fhe_sorting_tpu.models.kway import eval_utils as jeu
from fhe_sorting_tpu.models.kway import masking as jmask
from fhe_sorting_tpu.ops import sign as jsign
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys, SecretKeyMissing
from fhe_sorting_tpu_torch.models.kway import KWaySorter
from fhe_sorting_tpu_torch.models.kway import adapter as tadapter
from fhe_sorting_tpu_torch.models.kway import eval_utils as teu
from fhe_sorting_tpu_torch.models.kway import masking as tmask
from fhe_sorting_tpu_torch.ops import sign as tsign
from fhe_sorting_tpu_torch.utils import hbm_budget, kway_run

from .utils import vector_with_min_diff

torch.set_num_threads(2)

RING, DEPTH = 512, 36


def _port_keys(ctx, jkeys):
    return Keys.from_numpy(
        ctx, jkeys.s_coeffs, jkeys.s_eval, jkeys.pk[0], jkeys.pk[1],
        np.asarray(jkeys.relin.kb), np.asarray(jkeys.relin.ka),
        rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jkeys.rot.items()})


@pytest.fixture(scope="module")
def env():
    jctx = JContext(JParams(ring_n=RING, mult_depth=DEPTH))
    jkeys = JKeys.generate(jctx, seed=0)
    jkeys.gen_rotation_keys(sorted({1 << i for i in range(8)} | {-(1 << i) for i in range(8)}))
    keys = _port_keys(Context(CkksParams(ring_n=RING, mult_depth=DEPTH), device="cpu"), jkeys)
    return jkeys, JEvaluator(jctx, jkeys), keys, Evaluator(keys.ctx, keys)


def _cts(jkeys, x, slots):
    padded = np.zeros(slots)
    padded[: len(x)] = x
    j = jkeys.encrypt(padded, slots=slots, seed=1)
    return j, Ciphertext.from_numpy(np.asarray(j.data), j.level, j.sdeg, j.slots, "cpu")


def _same(to, jo, what):
    assert (to.level, to.sdeg, to.slots) == (jo.level, jo.sdeg, jo.slots), what
    np.testing.assert_array_equal(to.data.numpy(), np.asarray(jo.data).astype(np.int64), what)


def _cfgs(dg, df):
    return (jsign.SignConfig(jsign.CompositeSignConfig(3, dg, df)),
            tsign.SignConfig(tsign.CompositeSignConfig(3, dg, df)))


# -- the masking topology (pure numpy) --------------------------------------

@pytest.mark.parametrize("k,M", [(2, 1), (2, 2), (2, 3), (2, 4), (2, 5),
                                 (3, 1), (3, 2), (3, 3), (5, 1), (5, 2)])
def test_masking_matches_jax(k, M):
    assert tmask.num_stages(k, M) == jmask.num_stages(k, M)
    for stage in range(tmask.num_stages(k, M)):
        m, log_dist, slope = tmask.sort_type(k, M, stage)
        assert (m, log_dist, slope) == jmask.sort_type(k, M, stage)
        assert tmask.get_rotate_distance(k, log_dist, slope) == \
            jmask.get_rotate_distance(k, log_dist, slope)
        ind = tmask.gen_indices(k ** M, k, M, m, log_dist, slope)
        np.testing.assert_array_equal(ind, jmask.gen_indices(k ** M, k, M, m, log_dist, slope))
        assert np.all(ind[1] <= ind[0]) and ind[0].max() <= k
        for i0 in range(k + 1):
            for i1 in range(1, k + 1):
                np.testing.assert_array_equal(tmask.gen_mask(ind, i0, i1),
                                              jmask.gen_mask(ind, i0, i1))


@pytest.mark.parametrize("N", [2, 3, 4, 5, 8, 9, 16, 25, 27, 125, 6, 7])
def test_kway_decompose_matches_jax(N):
    try:
        want = jadapter.kway_decompose(N)
    except ValueError:
        with pytest.raises(ValueError, match="not a power"):
            tadapter.kway_decompose(N)
        return
    assert tadapter.kway_decompose(N) == want


# -- EvalUtils ---------------------------------------------------------------

@pytest.mark.parametrize("coeff", [0, 1, -3, 13])
def test_mult_by_int_matches_jax(env, coeff):
    jkeys, jev, keys, tev = env
    x = np.array([0.25, -0.5, 0.125, 0.0625])
    jct, ct = _cts(jkeys, x, 4)
    out = teu.mult_by_int(tev, ct, coeff)
    _same(out, jeu.mult_by_int(jev, jct, coeff), f"mult_by_int {coeff}")
    assert (out.level, out.sdeg) == (ct.level, ct.sdeg)
    np.testing.assert_allclose(keys.decrypt(out, 4), coeff * x, atol=1e-3)


@pytest.mark.parametrize("masked", [False, True])
def test_flip_ctxt_matches_jax(env, masked):
    jkeys, jev, keys, tev = env
    x = np.array([0.25, 0.75, 0.5, 0.125])
    mask = np.array([1.0, 0.0, 1.0, 0.0]) if masked else None
    jct, ct = _cts(jkeys, x, 4)
    out = teu.flip_ctxt(tev, ct, mask)
    _same(out, jeu.flip_ctxt(jev, jct, mask), "flip_ctxt")
    want = (mask if masked else 1.0) - x
    np.testing.assert_allclose(keys.decrypt(out, 4), want, atol=1e-3)


@pytest.mark.parametrize("r", [5, 12])
def test_left_right_rotate_match_jax(env, r):
    jkeys, jev, keys, tev = env
    x = np.arange(16) / 16.0
    jct, ct = _cts(jkeys, x, 16)
    left = teu.left_rotate(tev, ct, r)
    _same(left, jeu.left_rotate(jev, jct, r), "left_rotate")
    _same(teu.right_rotate(tev, ct, r), jeu.right_rotate(jev, jct, r), "right_rotate")
    np.testing.assert_allclose(keys.decrypt(left, 16), np.roll(x, -r), atol=1e-3)


def test_check_level_and_boot_matches_jax(env):
    """Without a bootstrap_fn a level past the budget raises the same
    "depth exhausted"; with one, both call it at the same levels."""
    jkeys, jev, keys, tev = env
    jct, ct = _cts(jkeys, np.array([0.5]), 1)
    jlow, low = jev.level_reduce(jct, DEPTH - 4), tev.level_reduce(ct, DEPTH - 4)
    msgs = []
    for mod, ev, c in ((jeu, jev, jlow), (teu, tev, low)):
        with pytest.raises(RuntimeError, match="depth exhausted") as exc:
            mod.check_level_and_boot(ev, c, 5)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    calls = ([], [])
    for mod, ev, c, seen in ((jeu, jev, jlow, calls[0]), (teu, tev, low, calls[1])):
        def boot(x, s=seen):
            s.append(x.level)
            return x

        for required in (0, 2, 3, 5):
            assert mod.check_level_and_boot(ev, c, required, boot) is c
        mod.check_level_and_boot2(ev, c, c, 5, lambda x, s=seen: boot(ev.negate(x), s))
    assert calls[0] == calls[1] == [DEPTH - 4] * 3


def test_debug_with_sk(env, capsys):
    """Prints through a key set that holds the secret; a secret-free one
    raises SecretKeyMissing."""
    jkeys, jev, keys, tev = env
    _, ct = _cts(jkeys, np.array([0.5, -0.75]), 2)
    teu.debug_with_sk(keys, ct, length=2, label="x")
    out = capsys.readouterr().out
    assert "check x" in out and "x max val = 1, 0.7" in out
    server = Keys(ctx=keys.ctx, s_coeffs=None, s_eval=None, pk=keys.pk)
    with pytest.raises(SecretKeyMissing):
        teu.debug_with_sk(server, ct)


# -- whole sorts and single stages -------------------------------------------

@pytest.mark.parametrize("k,x", [(3, [0.7, 0.2, 0.5]), (5, [0.9, 0.1, 0.5, 0.7, 0.3])])
def test_kway_sort_matches_jax(env, k, x):
    """k^1 values: one stage of the three- or five-sorter (JAX
    tests/test_kway.py:64-90)."""
    jkeys, jev, keys, tev = env
    x = np.array(x)
    slots = 1 << (k - 1).bit_length()
    jct, ct = _cts(jkeys, x, slots)
    jcfg, tcfg = _cfgs(1, 1)
    out = KWaySorter(tev, k, 1).sort(ct, tsign.SignFunc.CompositeSign, tcfg)
    _same(out, JKWaySorter(jev, k, 1).sort(jct, jsign.SignFunc.CompositeSign, jcfg),
          f"k={k} sort")
    assert np.abs(keys.decrypt(out, k) - np.sort(x)).max() < 0.01
    if k == 3:
        # the adapter is the sorter behind SortBase
        got = tadapter.KWayAdapter(tev, 3).sort(ct, tsign.SignFunc.CompositeSign, tcfg)
        _same(got, JKWaySorter(jev, k, 1).sort(jct, jsign.SignFunc.CompositeSign, jcfg),
              "adapter")


@pytest.mark.parametrize("stage", [2, 3, 4])
def test_kway_k5_stage_matches_jax(env, stage):
    """One stage of k=5, M=2 (N=25) through the stage window: sort_type
    gives slopes 1, 2 and 3, which run the mixed 2345 sorter, the two- and
    three-sorters, and the four-sorter."""
    jkeys, jev, keys, tev = env
    assert tmask.sort_type(5, 2, stage)[2] == stage - 1
    x = vector_with_min_diff(25, seed=9)
    jct, ct = _cts(jkeys, x, 32)
    jcfg, tcfg = _cfgs(1, 1)
    out = KWaySorter(tev, 5, 2).sort(ct, tsign.SignFunc.CompositeSign, tcfg,
                                     stage_lo=stage, stage_hi=stage + 1)
    jout = JKWaySorter(jev, 5, 2).sort(jct, jsign.SignFunc.CompositeSign, jcfg,
                                       stage_lo=stage, stage_hi=stage + 1)
    _same(out, jout, f"k=5 M=2 stage {stage}")


# -- the ring-2^17 run's configuration (`utils/kway_run.py`), at ring 1024 ---

def test_kway_run_builds_the_configuration():
    run = kway_run.build(16, ring=1024, device="cpu", capacity_gb=80.0)
    assert (run.sorter.k, run.sorter.M, run.sorter.rot) == (2, 4, run.rot)
    assert run.cfg == tsign.SignConfig(tsign.CompositeSignConfig(3, 3, 2), mult_depth=42)
    p = run.ctx.params
    assert (p.mult_depth, p.secret_hamming, p.first_mod_bits, p.comp, p.dnum) == (42, None, 30, 2, 3)
    steps = {1 << i for i in range(9)} | {-1, -2, -4, -8}
    want = {run.ctx.galois_element_rot(s % 512) for s in steps} | {2 * 1024 - 1}
    assert set(run.keys.rot) == want and run.rot.lazy_key_budget == kway_run.LAZY_KEYS
    assert run.ev.pt_cache_bytes == kway_run.refresh_plaintext_bytes(run.ctx, run.bs)
    np.testing.assert_array_equal(np.sort(run.vals), (np.arange(16) + 0.5) / 16)


def test_kway_run_keeps_the_default_memo_where_one_refresh_does_not_fit():
    """Where the room the reckoning leaves (keys, the network's ciphertexts and
    a refresh's working set) is below one refresh's plaintexts, the memo keeps
    the evaluator's default."""
    roomy = kway_run.build(16, ring=1024, device="cpu", capacity_gb=80.0)
    need = kway_run.refresh_plaintext_bytes(roomy.ctx, roomy.bs)
    assert roomy.report["n_cts"] == 8 + hbm_budget.WORK_CTS["bootstrap"]
    capacity = (roomy.report["used_gib"] + need / 2 / 2**30) / 0.8
    run = kway_run.build(16, ring=1024, device="cpu", capacity_gb=capacity)
    assert run.ev.pt_cache_bytes == Evaluator(run.ctx, run.keys).pt_cache_bytes
    assert run.memo.startswith("the default")


def test_kway_run_check_peak_fails_over_the_budget():
    run = SimpleNamespace(report={"budget_gib": 63.34, "used_gib": 40.33, "label": "k-way"})
    hbm_budget.check_peak(run.report, 63.0)
    with pytest.raises(MemoryError, match="67.84 GiB exceeds the 63.34 GiB budget"):
        hbm_budget.check_peak(run.report, 67.84)


def test_kway_run_rejects_what_it_cannot_build():
    with pytest.raises(ValueError, match="k=2"):
        kway_run.build(9, ring=1024, device="cpu", capacity_gb=80.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            kway_run.build(16, ring=1024)
