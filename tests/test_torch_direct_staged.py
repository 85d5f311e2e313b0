"""The PyTorch port's staged DirectSort against the JAX package.

The depth meters must agree, and the whole slice must too: at N=8 on ring
512 (the tests/test_direct_staged.py shape) both packages sort the same
input ciphertext with the same keys (the JAX keys, converted), and the
output limb planes must be bit-equal (tolerance 0); the port's decrypted
error must be below 0.01, the reference's accuracy contract."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu.models.direct_sort import DirectSort as JDirectSort
from fhe_sorting_tpu.models.direct_sort import rotation_indices_direct_sort as j_rot_idx
from fhe_sorting_tpu.ops import chebyshev as jcheb
from fhe_sorting_tpu.ops.sign import CompositeSignConfig as JCompositeSignConfig
from fhe_sorting_tpu.ops.sign import SignConfig as JSignConfig
from fhe_sorting_tpu.parallel.direct_staged import StagedDirectSort as JStagedDirectSort
from fhe_sorting_tpu.parallel.direct_scan import scan_rotation_indices as j_scan_idx
from fhe_sorting_tpu.utils.depth_meter import measure_direct_sort_depth as j_depth
from fhe_sorting_tpu.utils.sinc_coeffs import doubled_sinc_coefficients as j_sinc
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.models import direct_sort as tds
from fhe_sorting_tpu_torch.ops import chebyshev as tcheb
from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig
from fhe_sorting_tpu_torch.parallel.direct_staged import StagedDirectSort, scan_rotation_indices
from fhe_sorting_tpu_torch.utils.depth_meter import measure_direct_sort_depth
from fhe_sorting_tpu_torch.utils.sinc_coeffs import doubled_sinc_coefficients

torch.set_num_threads(2)


@pytest.mark.parametrize("N,ring,cfg", [
    (8, 512, (3, 2, 2)), (8, 512, (3, 3, 2)),
    (128, 1 << 17, (3, 4, 2)), (1024, 1 << 17, (3, 6, 2)),
])
def test_depth_meter_matches_jax(N, ring, cfg):
    got = measure_direct_sort_depth(N, ring, SignConfig(CompositeSignConfig(*cfg)))
    ref = j_depth(N, ring, JSignConfig(JCompositeSignConfig(*cfg)))
    assert got["mult_depth"] == ref["mult_depth"]
    assert got["final_level"] == ref["final_level"]


@pytest.mark.parametrize("N,ring", [(8, 512), (64, 4096), (128, 1 << 17), (1024, 1 << 17)])
def test_rotation_sets_and_masks_match_jax(N, ring):
    assert scan_rotation_indices(N, ring) == j_scan_idx(N, ring)
    assert tds.rotation_indices_direct_sort(N, ring) == j_rot_idx(N, ring)
    ref = JDirectSort.__new__(JDirectSort)
    ref.N = N
    P = min(N, (ring // 2) // N)
    num_slots = N * P
    np.testing.assert_array_equal(tds.mask_block(num_slots, 1, N), ref._mask_block(num_slots, 1, N))
    np.testing.assert_array_equal(tds.index_vector(N), ref._index_vector())
    np.testing.assert_array_equal(tds.checking_vector_n(N, num_slots, 3),
                                  ref._checking_vector_n(num_slots, 3))


def test_polynomial_coefficients_match_jax():
    assert doubled_sinc_coefficients(8, stretch=1.5) == j_sinc(8, stretch=1.5)
    np.testing.assert_array_equal(tcheb.chebyshev_fit(np.tanh, 63), jcheb.chebyshev_fit(np.tanh, 63))


def test_staged_sort_n8_matches_jax():
    N, ring = 8, 512
    vals = np.random.default_rng(0).permutation(N) / N + 0.5 / N

    jcfg = JSignConfig(JCompositeSignConfig(3, 2, 2))
    depth = j_depth(N, ring, jcfg)["mult_depth"]
    jctx = JContext(JParams(ring_n=ring, mult_depth=depth))
    jkeys = JKeys.generate(jctx, seed=0)
    jkeys.gen_rotation_keys(sorted(j_scan_idx(N, ring)))
    jct = jkeys.encrypt(vals, seed=0)
    jsrt = JStagedDirectSort(JEvaluator(jctx, jkeys, jit_ops=False), N, jcfg)
    jout = jsrt.index_check(jsrt.construct_rank(jct), jct)

    ctx = Context(CkksParams(ring_n=ring, mult_depth=depth), device="cpu")
    keys = Keys.from_numpy(
        ctx, jkeys.s_coeffs, jkeys.s_eval, jkeys.pk[0], jkeys.pk[1],
        np.asarray(jkeys.relin.kb), np.asarray(jkeys.relin.ka),
        rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jkeys.rot.items()})
    ct = Ciphertext.from_numpy(np.asarray(jct.data), jct.level, jct.sdeg, jct.slots, "cpu")
    srt = StagedDirectSort(Evaluator(ctx, keys), N, SignConfig(CompositeSignConfig(3, 2, 2)))
    out = srt(ct)

    assert (out.level, out.sdeg, out.slots) == (jout.level, jout.sdeg, jout.slots)
    np.testing.assert_array_equal(out.data.numpy(), np.asarray(jout.data).astype(np.int64))
    assert float(np.abs(keys.decrypt(out, N) - np.sort(vals)).max()) < 0.01
    assert srt.stages["A"].calls == 1 and srt.stages["A"].op_counts
