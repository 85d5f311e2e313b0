"""The PyTorch port's roofline against the JAX package's.

Held to the reference's cost model (a v5e `ChipSpec`, 4-byte residues,
log2(n) butterfly passes), every cost function and `accumulate_sol` over
the op tallies of the N=8 ring-512 staged sort give the JAX package's
floats exactly.  With the port's own model the butterfly NTT's bound on the
H100 is 0.106 ms for a forward NTT of [2, 68, 2^17], the same number as
`chip_smoke._ntt_bound`."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.utils import roofline as jroof
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig
from fhe_sorting_tpu_torch.parallel.direct_staged import StagedDirectSort, scan_rotation_indices
from fhe_sorting_tpu_torch.utils import roofline
from fhe_sorting_tpu_torch.utils.depth_meter import measure_direct_sort_depth

torch.set_num_threads(2)

N17 = 1 << 17


def _same(got, ref):
    assert (got.bytes_hbm, got.macs_mxu) == (ref.bytes_hbm, ref.macs_mxu)
    assert got.int_ops == 0
    assert got.sol_seconds(roofline.V5E) == ref.sol_seconds(jroof.V5E)
    assert got.bound(roofline.V5E) == ref.bound(jroof.V5E)


@pytest.mark.parametrize("n,limbs", [(1 << 12, 3), (N17, 68), (1 << 15, 7)])
def test_cost_functions_match_jax_v5e(n, limbs):
    K, D, alpha = 23, 3, 23
    _same(roofline.ntt_fourstep(n, limbs, 2, rb=4), jroof.ntt_fourstep(n, limbs, 2))
    _same(roofline.ntt_butterfly(n, limbs, 2, rb=4, passes=n.bit_length() - 1),
          jroof.ntt_butterfly(n, limbs, 2))
    _same(roofline.keyswitch(n, limbs, K, D, alpha, rb=4), jroof.keyswitch(n, limbs, K, D, alpha))
    _same(roofline.ct_mult(n, limbs, K, D, alpha, rb=4), jroof.ct_mult(n, limbs, K, D, alpha))
    _same(roofline.rescale(n, limbs, 2, rb=4), jroof.rescale(n, limbs, 2))
    _same(roofline.modup(n, limbs, K, D, alpha, rb=4), jroof.modup(n, limbs, K, D, alpha))
    _same(roofline.elementwise(n, limbs, rb=4), jroof.elementwise(n, limbs))
    _same(roofline.combo_cost(n, limbs, 9, 4, rb=4), jroof.combo_cost(n, limbs, 9, 4))
    cost = roofline.ct_mult(n, limbs, K, D, alpha, rb=4)
    ref = jroof.ct_mult(n, limbs, K, D, alpha)
    assert roofline.report("x", cost, 1e-3, roofline.V5E) == jroof.report("x", ref, 1e-3)


def test_accumulate_sol_matches_jax_on_staged_phase_stats():
    N, ring = 8, 512
    cfg = SignConfig(CompositeSignConfig(3, 2, 2))
    depth = measure_direct_sort_depth(N, ring, cfg)["mult_depth"]
    ctx = Context(CkksParams(ring_n=ring, mult_depth=depth), device="cpu")
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys(sorted(scan_rotation_indices(N, ring)))
    srt = StagedDirectSort(Evaluator(ctx, keys), N, cfg)
    srt(keys.encrypt(np.random.default_rng(0).permutation(N) / N + 0.5 / N, seed=0))
    phases = srt.phase_stats()
    assert phases["constructRank"] and phases["rotationIndexCheck"]
    # the reference's model charges the four-step NTT: a four-step context
    fs_ctx = Context(CkksParams(ring_n=ring, mult_depth=depth, ntt_impl="mxu"), device="cpu")
    jctx = JContext(JParams(ring_n=ring, mult_depth=depth))
    assert fs_ctx.all_primes == list(jctx.all_primes)
    for level in range(depth + 1):
        assert roofline.ks_geometry(fs_ctx, level) == jroof.ks_geometry(jctx, level)
    for stats in (*phases.values(), srt.stage_stats()):
        got = roofline.accumulate_sol(fs_ctx, stats, roofline.V5E, rb=4)
        assert got == jroof.accumulate_sol(jctx, stats)
    # the port's own model on the sort's (butterfly) context: K2's NTT
    total, parts = roofline.accumulate_sol(ctx, srt.stage_stats())
    assert ctx.ntt_impl == "butterfly" and total == pytest.approx(sum(parts.values()))
    units = roofline.sol_by_bound(ctx, srt.stage_stats())
    assert set(units) <= {"HBM", "tensor cores", "CUDA cores"}
    assert sum(units.values()) == pytest.approx(total)
    # phase_sol: both, phase by phase
    for ph, (sol, by_op, by_unit) in roofline.phase_sol(ctx, phases).items():
        assert (sol, by_op) == roofline.accumulate_sol(ctx, phases[ph])
        assert by_unit == roofline.sol_by_bound(ctx, phases[ph])


def test_h100_ntt_bound_is_chip_smokes():
    import chip_smoke

    cost = roofline.ntt_butterfly(N17, 68, 2)
    ms = cost.sol_seconds(roofline.H100) * 1e3
    assert ms == pytest.approx(0.1064, abs=5e-4) and cost.bound(roofline.H100) == "HBM"
    (bound_ms, by), ops_ms = chip_smoke._ntt_bound(2 * 68, 68, N17)
    assert (bound_ms, by) == (ms, "bytes")
    assert ops_ms == cost.int_ops / roofline.H100.int_ops_s * 1e3
    # the H100's rates are NVIDIA's published SXM peaks at 700 W
    assert (roofline.H100.hbm_bytes_s, roofline.H100.mxu_macs_s * 2,
            roofline.H100.int_ops_s) == (3.35e12, 1979e12, 67e12)
