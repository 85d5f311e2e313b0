"""The port's ScanDirectSort (`parallel/direct_scan.py`) against the JAX package.

Both packages sort the same input ciphertext under the same keys (the JAX
keys, converted), at N=8 on ring 512 (one batch) and at N=16 on ring 64
(eight batches, so the per-batch body is replayed with its carry).  The
port runs its bodies eagerly here, as on any CPU context.  Its `phase_stats`
must equal the tallies the JAX `build()` records, key for key (the body's
times the batches), and its decrypted error must be below 0.01, the
reference's accuracy contract.  The output limb planes must equal the JAX
sort's (tolerance 0); the JAX side compiles each phase as one program with
the batches under `lax.scan`, minutes on the CPU, so those two cases are
`slow`."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu.ops.sign import CompositeSignConfig as JCompositeSignConfig
from fhe_sorting_tpu.ops.sign import SignConfig as JSignConfig
from fhe_sorting_tpu.parallel.direct_scan import ScanDirectSort as JScanDirectSort
from fhe_sorting_tpu.parallel.direct_scan import scan_rotation_indices as j_scan_idx
from fhe_sorting_tpu.utils.depth_meter import measure_direct_sort_depth as j_depth
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig
from fhe_sorting_tpu_torch.parallel import direct_staged
from fhe_sorting_tpu_torch.parallel.direct_scan import ScanDirectSort, scan_rotation_indices

torch.set_num_threads(2)

CASES = {"N8_ring512": (8, 512, (3, 2, 2)), "N16_ring64": (16, 64, (3, 3, 2))}
_RUNS: dict = {}


def _run(case):
    """(JAX sort after build(), its input, port sort, port output, port keys,
    values) of one case, made once per module."""
    if case not in _RUNS:
        N, ring, cfg = CASES[case]
        jcfg = JSignConfig(JCompositeSignConfig(*cfg))
        # the JAX package's own test chain: the metered depth plus one
        depth = j_depth(N, ring, jcfg)["mult_depth"] + 1
        jctx = JContext(JParams(ring_n=ring, mult_depth=depth))
        jkeys = JKeys.generate(jctx, seed=0)
        jkeys.gen_rotation_keys(sorted(j_scan_idx(N, ring)))
        vals = np.random.default_rng(0).permutation(N) / N + 0.5 / N
        jct = jkeys.encrypt(vals, seed=0)
        jsrt = JScanDirectSort(JEvaluator(jctx, jkeys, jit_ops=False), N, jcfg).build(jct)

        ctx = Context(CkksParams(ring_n=ring, mult_depth=depth), device="cpu")
        keys = Keys.from_numpy(
            ctx, jkeys.s_coeffs, jkeys.s_eval, jkeys.pk[0], jkeys.pk[1],
            np.asarray(jkeys.relin.kb), np.asarray(jkeys.relin.ka),
            rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jkeys.rot.items()})
        ct = Ciphertext.from_numpy(np.asarray(jct.data), jct.level, jct.sdeg, jct.slots, "cpu")
        srt = ScanDirectSort(Evaluator(ctx, keys), N, SignConfig(CompositeSignConfig(*cfg)))
        _RUNS[case] = (jsrt, jct, srt, srt(ct), keys, vals)
    return _RUNS[case]


@pytest.mark.parametrize("N,ring", [(8, 512), (16, 64), (128, 1 << 17), (1024, 1 << 17)])
def test_scan_rotation_indices_match_jax(N, ring):
    assert scan_rotation_indices(N, ring) == j_scan_idx(N, ring)
    assert scan_rotation_indices is direct_staged.scan_rotation_indices


@pytest.mark.parametrize("case", CASES)
def test_phase_stats_match_jax(case):
    jsrt, _, srt, _, _, _ = _run(case)
    assert (srt.P, srt.nb, srt.np_) == (jsrt.P, jsrt.nb, jsrt.np_)
    assert srt.phase_stats.keys() == jsrt.phase_stats.keys()
    for phase, counts in srt.phase_stats.items():
        assert counts == +jsrt.phase_stats[phase], phase
    # one dispatch of each graph a sort, the body one per batch
    assert {k: v[0] for k, v in srt.graph_stats().items()} == {
        "p1_body": srt.nb, "p1_tail": 1, "p2_head": 1, "p2_body": srt.nb, "p2_tail": 1}


@pytest.mark.parametrize("case", CASES)
def test_port_scan_sort_error(case):
    _, _, srt, out, keys, vals = _run(case)
    N = CASES[case][0]
    assert out.slots == N and srt.nb == N // srt.P
    assert float(np.abs(keys.decrypt(out, N) - np.sort(vals)).max()) < 0.01


@pytest.mark.slow
@pytest.mark.parametrize("case", CASES)
def test_scan_sort_matches_jax(case):
    jsrt, jct, _, out, _, _ = _run(case)
    jout = jsrt(jct)
    assert (out.level, out.sdeg, out.slots) == (jout.level, jout.sdeg, jout.slots)
    np.testing.assert_array_equal(out.data.numpy(), np.asarray(jout.data).astype(np.int64))


def test_scan_graphs_need_a_cuda_context():
    ctx = Context(CkksParams(ring_n=64, mult_depth=4), device="cpu")
    ev = Evaluator(ctx, Keys.generate(ctx, seed=0))
    with pytest.raises(ValueError, match="CUDA context"):
        ScanDirectSort(ev, 8, SignConfig(CompositeSignConfig(3, 2, 2)), graphs=True)
