"""The port's staged N>256 regimes at CPU size: the hybrid DirectSort over
max_array-wide tiles (`parallel/hybrid_staged.py`) and the MEHP24
multi-ciphertext triangle (`parallel/mehp24_staged.py`), each over two tiles
at ring 512.  The key bases equal the JAX package's; the sorts decrypt
within 0.01 of `np.sort`, the reference tests' bound, and count their stage
calls.  The whole-sort limb-plane parity with the JAX package's staged
classes (tolerance 0) is marked slow, as the JAX package marks its own sorts
of these classes."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.parallel import hybrid_staged as jhyb
from fhe_sorting_tpu.parallel import mehp24_staged as jmst
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.ops.rotation import DecomposeAlgo, Decomposer
from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig
from fhe_sorting_tpu_torch.parallel.direct_staged import scan_rotation_indices
from fhe_sorting_tpu_torch.parallel.hybrid_staged import StagedHybridSort, hybrid_staged_keys
from fhe_sorting_tpu_torch.parallel.mehp24_staged import StagedMehp24Multi, mehp24_staged_keys
from fhe_sorting_tpu_torch.utils import large_sort
from fhe_sorting_tpu_torch.utils.depth_meter import MeterEvaluator

torch.set_num_threads(2)

RING = 512
HYB = dict(N=8, max_array=4, indicator_dg=2, depth=38)
MEHP = dict(total=16, sub=8, dg_c=2, df_c=2, dg_i=3, df_i=2, depth=40)


@pytest.mark.parametrize("N,ring,max_array", [(512, 1 << 17, 256), (1024, 1 << 17, 256),
                                              (2048, 1 << 17, 256), (128, 1 << 17, 64),
                                              (8, 512, 4), (256, 1 << 17, 256)])
def test_hybrid_staged_keys_match_jax(N, ring, max_array):
    assert hybrid_staged_keys(N, ring, max_array) == jhyb.hybrid_staged_keys(N, ring, max_array)


@pytest.mark.parametrize("sub,ring", [(256, 1 << 17), (64, 1 << 17), (8, 512), (4, 256)])
def test_mehp24_staged_keys_match_jax(sub, ring):
    assert mehp24_staged_keys(sub, ring) == jmst.mehp24_staged_keys(sub, ring)


def test_hybrid_placement_steps_decompose():
    """Every fold amount the N=512 placement asks for decomposes over the
    basis in at most 13 keyed hops."""
    idx = hybrid_staged_keys(512, 1 << 17)
    assert {1, -1, 256} <= idx and len(idx) <= 10
    dec = Decomposer(sorted(idx), 65536, DecomposeAlgo.NAF)
    T = 256 * 255 // 2
    for a in [256 >> i for i in range(1, 9)] + [T >> i for i in range(8)] + [-1, -255]:
        parts = dec.decompose(a)
        assert sum(parts) % 65536 == a % 65536 and len(parts) <= 13, (a, parts)


@pytest.mark.parametrize("build", ["staged_hybrid", "staged_mehp24"])
def test_large_sort_configurations_run_on_the_card(build):
    """The N=512 configurations of `large_sort` (and of `chip_smoke.py` phase 12)
    default to the first CUDA card and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(large_sort, build)(512)


@pytest.mark.parametrize("plan,N,depth", [("hybrid_plan", 512, 48), ("mehp24_plan", 512, 46)])
def test_large_sort_depths_are_the_reference_runs(plan, N, depth):
    """The depths the builders meter on the staged classes at N=512 are the
    chains of the reference's runs (`experiment_results/direct_tpu/
    N512_hybrid.json`, `experiment_results/mehp24_tpu/N512_sub256.json`)."""
    assert getattr(large_sort, plan)(N)[1] == depth


@pytest.mark.parametrize("levels", [((3, 1), (5, 2)), ((4, 2), (4, 1), (6, 1)), ((2, 2), (2, 1))])
def test_meter_align_group_matches_the_evaluator(levels):
    """The depth meter's `align_group` lands every ciphertext on the
    (level, sdeg) that the evaluator's does, and meters the levels it spends."""
    keys = Keys.generate(Context(CkksParams(ring_n=256, mult_depth=8), device="cpu"), seed=0)
    ev, meter = Evaluator(keys.ctx, keys), MeterEvaluator(256)
    cts = [keys.encrypt(np.full(4, 0.25), slots=4) for _ in levels]
    cts = [ev.level_reduce(c, lvl) if sdeg == 1 else ev.mult(ev.level_reduce(c, lvl - 1), 1.0)
           for c, (lvl, sdeg) in zip(cts, levels)]
    assert [(c.level, c.sdeg) for c in cts] == [(lvl - (sdeg == 2), sdeg) for lvl, sdeg in levels]
    got = meter.align_group([Ciphertext(None, c.level, c.sdeg, 4) for c in cts])
    want = ev.align_group(cts)
    assert [(c.level, c.sdeg) for c in got] == [(c.level, c.sdeg) for c in want]
    assert meter.max_level <= max(c.level for c in want)


def _input(keys, n, slots):
    vals = np.random.default_rng(0).permutation(n) / n + 0.5 / n
    pad = np.zeros(slots)
    pad[:n] = vals
    return vals, keys.encrypt(pad, slots=slots, seed=1)


def _hybrid_port(keys=None):
    if keys is None:
        keys = Keys.generate(Context(CkksParams(ring_n=RING, mult_depth=HYB["depth"]),
                                     device="cpu"), seed=0)
        keys.gen_rotation_keys(sorted(scan_rotation_indices(HYB["N"], RING)
                                      | hybrid_staged_keys(HYB["N"], RING, HYB["max_array"])))
    cfg = SignConfig(CompositeSignConfig(3, 3, 2))
    return keys, StagedHybridSort(Evaluator(keys.ctx, keys), HYB["N"], cfg,
                                  max_array=HYB["max_array"], indicator_dg=HYB["indicator_dg"])


def _mehp_port(keys=None):
    if keys is None:
        keys = Keys.generate(Context(CkksParams(ring_n=RING, mult_depth=MEHP["depth"]),
                                     device="cpu"), seed=0)
        keys.gen_rotation_keys(sorted(mehp24_staged_keys(MEHP["sub"], RING)))
    srt = StagedMehp24Multi(Evaluator(keys.ctx, keys), MEHP["total"], MEHP["sub"], MEHP["dg_c"],
                            MEHP["df_c"], MEHP["dg_i"], MEHP["df_i"])
    return keys, srt


def test_staged_hybrid_sort_two_tiles():
    """N=8 over two 4-wide tiles with the sign indicator: the code path of
    the reference's N=512 over 256-wide tiles."""
    keys, srt = _hybrid_port()
    N, nb = HYB["N"], srt.num_batch
    assert nb == 2 and srt.size == 4 and srt.num_slots == RING // 2
    vals, ct = _input(keys, N, N)
    got = keys.decrypt(srt(ct), N)
    assert np.abs(got - np.sort(vals)).max() < 0.01
    calls = {name: st.calls for name, st in srt.stages.items()}
    iters = HYB["indicator_dg"] + 2
    assert calls["Hprep"] == calls["Hfin"] == 1
    assert calls["Hcomb"] == nb * nb
    assert sum(c for name, c in calls.items() if name.startswith("HB")) == iters * nb * nb
    assert all(calls[f"{s}{b}"] == (nb if s == "Hsub" else 1)
               for b in range(nb) for s in ("Hrot", "Hsub", "HplaceS"))
    assert all(calls[f"HplaceT{b}{part}"] == 1 for b in range(nb) for part in "abc")
    assert srt.base.stages["D"].calls == 1


def test_staged_mehp24_sort_two_tiles():
    """16 values over two 8x8 tiles: the triangle, Cv/Ch and placement of the
    reference's N=512 over sub-length 256."""
    keys, srt = _mehp_port()
    total, k = MEHP["total"], srt.k
    vals, ct = _input(keys, total, MEHP["sub"] ** 2)
    out = srt(ct)
    got = keys.decrypt(out, total)
    assert np.abs(got - np.sort(vals)).max() < 0.01
    # the depth meter, which sizes `large_sort.staged_mehp24`'s chain, ends
    # where the real sort ends
    meter = MeterEvaluator(RING)
    metered = StagedMehp24Multi(meter, total, MEHP["sub"], MEHP["dg_c"], MEHP["df_c"],
                                MEHP["dg_i"], MEHP["df_i"])(Ciphertext(None, 0, 1, ct.slots))
    assert (metered.level, metered.sdeg) == (out.level, out.sdeg) == (meter.max_level, 2)
    calls = {name: st.calls for name, st in srt.stages.items()}
    assert sum(calls.values()) < 30
    assert calls["cmp"] == k * (k + 1) // 2 and calls["ind"] == k * k
    assert calls["repl"] == calls["sv"] == calls["place"] == k
    assert calls["split"] == calls["combine"] == calls["align"] == 1


def _jax_keys_for(ctx, jkeys):
    return Keys.from_numpy(
        ctx, jkeys.s_coeffs, jkeys.s_eval, jkeys.pk[0], jkeys.pk[1],
        np.asarray(jkeys.relin.kb), np.asarray(jkeys.relin.ka),
        rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jkeys.rot.items()})


def _same_sort(jsrt, tsrt, jkeys, n, slots):
    pad = np.zeros(slots)
    pad[:n] = np.random.default_rng(0).permutation(n) / n + 0.5 / n
    jct = jkeys.encrypt(pad, slots=slots, seed=1)
    ct = Ciphertext.from_numpy(np.asarray(jct.data), jct.level, jct.sdeg, jct.slots, "cpu")
    out, jout = tsrt(ct), jsrt(jct)
    assert (out.level, out.sdeg, out.slots) == (jout.level, jout.sdeg, jout.slots)
    np.testing.assert_array_equal(out.data.numpy(), np.asarray(jout.data).astype(np.int64))


@pytest.mark.slow
def test_staged_hybrid_matches_jax():
    from fhe_sorting_tpu.core.context import CkksParams as JParams
    from fhe_sorting_tpu.core.context import Context as JContext
    from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
    from fhe_sorting_tpu.core.keys import Keys as JKeys
    from fhe_sorting_tpu.ops import sign as jsign
    from fhe_sorting_tpu.parallel.direct_scan import scan_rotation_indices as jscan

    jctx = JContext(JParams(ring_n=RING, mult_depth=HYB["depth"]))
    jkeys = JKeys.generate(jctx, seed=0)
    jkeys.gen_rotation_keys(sorted(set(jscan(HYB["N"], RING))
                                   | jhyb.hybrid_staged_keys(HYB["N"], RING, HYB["max_array"])))
    jsrt = jhyb.StagedHybridSort(
        JEvaluator(jctx, jkeys, jit_ops=False), HYB["N"],
        jsign.SignConfig(jsign.CompositeSignConfig(3, 3, 2)), max_array=HYB["max_array"],
        indicator_dg=HYB["indicator_dg"])
    ctx = Context(CkksParams(ring_n=RING, mult_depth=HYB["depth"]), device="cpu")
    _, tsrt = _hybrid_port(_jax_keys_for(ctx, jkeys))
    _same_sort(jsrt, tsrt, jkeys, HYB["N"], HYB["N"])


@pytest.mark.slow
def test_staged_mehp24_matches_jax():
    from fhe_sorting_tpu.core.context import CkksParams as JParams
    from fhe_sorting_tpu.core.context import Context as JContext
    from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
    from fhe_sorting_tpu.core.keys import Keys as JKeys

    jctx = JContext(JParams(ring_n=RING, mult_depth=MEHP["depth"]))
    jkeys = JKeys.generate(jctx, seed=0)
    jkeys.gen_rotation_keys(sorted(jmst.mehp24_staged_keys(MEHP["sub"], RING)))
    jsrt = jmst.StagedMehp24Multi(JEvaluator(jctx, jkeys, jit_ops=False), MEHP["total"],
                                  MEHP["sub"], MEHP["dg_c"], MEHP["df_c"], MEHP["dg_i"],
                                  MEHP["df_i"])
    ctx = Context(CkksParams(ring_n=RING, mult_depth=MEHP["depth"]), device="cpu")
    _, tsrt = _mehp_port(_jax_keys_for(ctx, jkeys))
    _same_sort(jsrt, tsrt, jkeys, MEHP["total"], MEHP["sub"] ** 2)
