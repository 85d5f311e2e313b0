"""The slice as a whole: the port's per-op DirectSort against the JAX package.

N=8 on ring 512 (the tests/test_direct_sort.py shape, depth from the depth
meter): both packages sort the same input ciphertext with the same keys (the
JAX keys, converted through numpy) over the full per-op key set.  The rank
ciphertext and the output limb planes must be bit-equal (tolerance 0), the
rotation engines must count the same stats, and the port's decrypted error
must be below 0.01, the reference's accuracy contract.  The JAX evaluator
runs with its per-op jit, which costs less here than its eager form."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu.models import direct_sort as jds
from fhe_sorting_tpu.ops import sign as jsign
from fhe_sorting_tpu.utils.depth_meter import measure_direct_sort_depth as j_depth
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.models import direct_sort as tds
from fhe_sorting_tpu_torch.ops import sign as tsign
from fhe_sorting_tpu_torch.utils.depth_meter import measure_direct_sort_depth

torch.set_num_threads(2)


@pytest.mark.parametrize("N,ring,cfg,hybrid", [
    (8, 512, (3, 2, 2), False), (8, 512, (3, 3, 2), True),
    (128, 1 << 17, (3, 4, 2), False), (1024, 1 << 17, (3, 6, 2), False),
    (512, 1 << 17, (3, 5, 2), True),
])
def test_per_op_depth_meter_matches_jax(N, ring, cfg, hybrid):
    got = measure_direct_sort_depth(N, ring, tsign.SignConfig(tsign.CompositeSignConfig(*cfg)),
                                    hybrid=hybrid, staged=False)
    ref = j_depth(N, ring, jsign.SignConfig(jsign.CompositeSignConfig(*cfg)), hybrid=hybrid)
    assert got == ref


@pytest.mark.parametrize("N,ring", [(4, 512), (8, 512), (128, 1 << 17), (1024, 1 << 17)])
def test_rotation_sets_and_2n_masks_match_jax(N, ring):
    assert tds.rotation_indices_direct_sort_2n(N, ring) == jds.rotation_indices_direct_sort_2n(N, ring)
    assert (tds.rotation_indices_direct_sort_hybrid(N, ring)
            == jds.rotation_indices_direct_sort_hybrid(N, ring))
    assert (tds.rotation_indices_direct_sort_hybrid(N, ring, max_array=4)
            == jds.rotation_indices_direct_sort_hybrid(N, ring, max_array=4))
    ref = jds.DirectSort.__new__(jds.DirectSort)
    ref.N = N
    for num_slots in (2 * N * 4, N * 5):       # whole pairs, and a cut pair
        for k in (0, 3):
            np.testing.assert_array_equal(tds.checking_vector_2n(N, num_slots, k),
                                          ref._checking_vector_2n(num_slots, k))
    assert tds._np_2n(16) == jds._np_2n(16) and tds._np_2n(2) == jds._np_2n(2)


def _sort_both(vals):
    """The same input ciphertext and keys through both packages' per-op
    DirectSort at N=8, ring 512; the planes of rank and output must be
    bit-equal.  Returns (port's keys, rank, output, the two sorters)."""
    N, ring = 8, 512
    jcfg = jsign.SignConfig(jsign.CompositeSignConfig(3, 2, 2))
    tcfg = tsign.SignConfig(tsign.CompositeSignConfig(3, 2, 2))
    depth = j_depth(N, ring, jcfg)["mult_depth"]
    steps = sorted(jds.rotation_indices_direct_sort(N, ring))

    jctx = JContext(JParams(ring_n=ring, mult_depth=depth))
    jkeys = JKeys.generate(jctx, seed=0)
    jkeys.gen_rotation_keys(steps)
    jct = jkeys.encrypt(vals, seed=0)
    jsrt = jds.DirectSort(JEvaluator(jctx, jkeys), N)
    jrank = jsrt.construct_rank(jct, jsign.SignFunc.CompositeSign, jcfg)
    jout = jsrt.rotation_index_check_n(jrank, jct)

    ctx = Context(CkksParams(ring_n=ring, mult_depth=depth), device="cpu")
    keys = Keys.from_numpy(
        ctx, jkeys.s_coeffs, jkeys.s_eval, jkeys.pk[0], jkeys.pk[1],
        np.asarray(jkeys.relin.kb), np.asarray(jkeys.relin.ka),
        rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jkeys.rot.items()})
    ct = Ciphertext.from_numpy(np.asarray(jct.data), jct.level, jct.sdeg, jct.slots, "cpu")
    srt = tds.DirectSort(Evaluator(ctx, keys), N)
    # one sort through the public entry point; the rank it builds on the way
    # is kept for the comparison
    ranks = []
    construct_rank = srt.construct_rank
    srt.construct_rank = lambda *a: ranks.append(construct_rank(*a)) or ranks[-1]
    out = srt.sort(ct, tsign.SignFunc.CompositeSign, tcfg)
    (rank,) = ranks
    assert (rank.level, rank.sdeg, rank.slots) == (jrank.level, jrank.sdeg, jrank.slots)
    np.testing.assert_array_equal(rank.data.numpy(), np.asarray(jrank.data).astype(np.int64))
    assert (out.level, out.sdeg, out.slots) == (jout.level, jout.sdeg, jout.slots)
    np.testing.assert_array_equal(out.data.numpy(), np.asarray(jout.data).astype(np.int64))
    # the reference decrypts its own output to the same values
    np.testing.assert_allclose(jkeys.decrypt(jout, N), keys.decrypt(out, N), atol=1e-9)
    return keys, rank, out, srt, jsrt


def test_direct_sort_n8_matches_jax():
    N = 8
    vals = np.random.default_rng(0).permutation(N) / N + 0.5 / N
    keys, rank, out, srt, jsrt = _sort_both(vals)
    assert float(np.abs(keys.decrypt(out, N) - np.sort(vals)).max()) < 0.01
    # the rank is the plain rank to ~1e-2 (the sinc indicator's margin)
    plain_rank = np.array([np.sum(v > vals) for v in vals], dtype=np.float64)
    np.testing.assert_allclose(keys.decrypt(rank, N), plain_rank, atol=1e-2)
    ts, js = srt.rot.stats, jsrt.rot.stats
    assert ts.fast_rotations == js.fast_rotations and ts.composed == js.composed == 0
    assert ts.rotations == js.rotations and ts.calls == js.calls
    assert srt.ev.op_stats[("rot_pre", out.level - 1)] >= 1


def test_direct_sort_tied_input_matches_jax():
    """The rank sort breaks no ties, in either package: tied values share one
    rank, rank = #(smaller) + (k - 1) / 2 for a group of k, so they pile into
    one slot (odd k) or spread over its neighbours (even k), and the output is
    not the sorted vector.  Both packages give the same planes; the error is
    pinned so that a tie rule, when one lands, has to change this test."""
    N = 8
    vals = np.array([0.3125, 0.8125, 0.3125, 0.0625, 0.5625, 0.3125, 0.8125, 0.6875])
    keys, rank, out, _, _ = _sort_both(vals)
    tied_rank = np.array([np.sum(v > vals) + (np.sum(v == vals) - 1) / 2 for v in vals])
    np.testing.assert_allclose(keys.decrypt(rank, N), tied_rank, atol=1e-2)
    err = float(np.abs(keys.decrypt(out, N) - np.sort(vals)).max())
    assert abs(err - 0.6867) < 1e-3
