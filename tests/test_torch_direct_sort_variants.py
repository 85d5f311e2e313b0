"""The per-op DirectSort's other entry points against the JAX package at N=4:
`construct_rank`, the 2N-wide sinc placement `rotation_index_check_2n`, and
`sort_hybrid` (the matrix placement).

Ring 256, depth from the depth meter, the JAX package's keys converted
through numpy: every output limb plane must be bit-equal (tolerance 0);
decrypted values are held against the plain result with the tolerance stated
at each check.  One JAX evaluator (per-op jit) serves the whole file."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu.models import direct_sort as jds
from fhe_sorting_tpu.ops import rotation as jrot
from fhe_sorting_tpu.ops import sign as jsign
from fhe_sorting_tpu.utils.depth_meter import measure_direct_sort_depth as j_depth
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.models import direct_sort as tds
from fhe_sorting_tpu_torch.ops import rotation as trot
from fhe_sorting_tpu_torch.ops import sign as tsign

torch.set_num_threads(2)

N, RING = 4, 256
CFG = (3, 2, 2)


@pytest.fixture(scope="module")
def env():
    jcfg = jsign.SignConfig(jsign.CompositeSignConfig(*CFG))
    depth = max(j_depth(N, RING, jcfg)["mult_depth"],
                j_depth(N, RING, jcfg, hybrid=True)["mult_depth"])
    steps = (jds.rotation_indices_direct_sort(N, RING)
             | jds.rotation_indices_direct_sort_2n(N, RING)
             | jds.rotation_indices_direct_sort_hybrid(N, RING))
    jctx = JContext(JParams(ring_n=RING, mult_depth=depth))
    jkeys = JKeys.generate(jctx, seed=0)
    jkeys.gen_rotation_keys(sorted(steps))
    ctx = Context(CkksParams(ring_n=RING, mult_depth=depth), device="cpu")
    keys = Keys.from_numpy(
        ctx, jkeys.s_coeffs, jkeys.s_eval, jkeys.pk[0], jkeys.pk[1],
        np.asarray(jkeys.relin.kb), np.asarray(jkeys.relin.ka),
        rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jkeys.rot.items()})
    return jkeys, JEvaluator(jctx, jkeys), keys, Evaluator(ctx, keys)


def _cts(jkeys, x, seed, **kw):
    j = jkeys.encrypt(x, seed=seed, **kw)
    return j, Ciphertext.from_numpy(np.asarray(j.data), j.level, j.sdeg, j.slots, "cpu")


def _same(to, jo, what):
    assert (to.level, to.sdeg, to.slots) == (jo.level, jo.sdeg, jo.slots), what
    np.testing.assert_array_equal(to.data.numpy(), np.asarray(jo.data).astype(np.int64), what)


def _vals(seed):
    return np.random.default_rng(seed).permutation(N) / N + 0.5 / N


def _plain_rank(x):
    return np.array([np.sum(v > x) for v in x], dtype=np.float64)


def test_construct_rank_matches_jax(env):
    jkeys, jev, keys, tev = env
    x = _vals(1)
    jct, ct = _cts(jkeys, x, 1)
    jrank = jds.DirectSort(jev, N).construct_rank(
        jct, jsign.SignFunc.CompositeSign, jsign.SignConfig(jsign.CompositeSignConfig(*CFG)))
    rank = tds.DirectSort(tev, N).construct_rank(
        ct, tsign.SignFunc.CompositeSign, tsign.SignConfig(tsign.CompositeSignConfig(*CFG)))
    _same(rank, jrank, "construct_rank")
    np.testing.assert_allclose(keys.decrypt(rank, N), _plain_rank(x), atol=1e-2)


def test_rotation_index_check_2n_matches_jax(env):
    """The placement on an encrypted plaintext-computed rank."""
    jkeys, jev, keys, tev = env
    x = _vals(6)
    jct, ct = _cts(jkeys, x, 1)
    jrk, rk = _cts(jkeys, _plain_rank(x), 2)
    steps = sorted(jds.rotation_indices_direct_sort_2n(N, RING))
    jsrt = jds.DirectSort(jev, N, rot=jrot.RotationComposer(jev, steps))
    srt = tds.DirectSort(tev, N, rot=trot.RotationComposer(tev, steps))
    jout, out = jsrt.rotation_index_check_2n(jrk, jct), srt.rotation_index_check_2n(rk, ct)
    _same(out, jout, "rotation_index_check_2n")
    np.testing.assert_allclose(keys.decrypt(out, N), np.sort(x), atol=5e-3)
    assert srt.rot.stats.fast_rotations == jsrt.rot.stats.fast_rotations
    assert srt.rot.stats.rotations == jsrt.rot.stats.rotations


def test_sort_hybrid_matches_jax(env):
    jkeys, jev, keys, tev = env
    x = _vals(7)
    jct, ct = _cts(jkeys, x, 1, slots=N)
    steps = jds.rotation_indices_direct_sort_hybrid(N, RING)
    jsrt = jds.DirectSort(jev, N, rot=jrot.RotationComposer(jev, steps))
    srt = tds.DirectSort(tev, N, rot=trot.RotationComposer(tev, steps))
    jout = jsrt.sort_hybrid(jct, jsign.SignFunc.CompositeSign,
                            jsign.SignConfig(jsign.CompositeSignConfig(*CFG)))
    out = srt.sort_hybrid(ct, tsign.SignFunc.CompositeSign,
                          tsign.SignConfig(tsign.CompositeSignConfig(*CFG)))
    _same(out, jout, "sort_hybrid")
    assert float(np.abs(keys.decrypt(out, N) - np.sort(x)).max()) < 0.01
