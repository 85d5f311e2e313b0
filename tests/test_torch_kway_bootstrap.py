"""The port's k-way sort with real bootstraps against the JAX package's on
shared keys: k=2, M=2 at ring 256, depth 22, a sparse secret (hamming 64)
and a 30-bit first modulus, where the sort cannot finish without refreshing
(JAX tests/test_kway.py:112-154).  Output limb planes bit-equal (tolerance
0), the bootstrap fires at the same levels in both packages, and the
decrypted sort is within 0.01 of `np.sort`."""

import numpy as np
import torch

from fhe_sorting_tpu.core.bootstrap import Bootstrapper as JBootstrapper
from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu.models.kway import KWaySorter as JKWaySorter
from fhe_sorting_tpu.ops import sign as jsign
from fhe_sorting_tpu_torch.core.bootstrap import Bootstrapper
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.models.kway import KWaySorter
from fhe_sorting_tpu_torch.ops import sign as tsign

from .utils import vector_with_min_diff

torch.set_num_threads(2)

PARAMS = dict(ring_n=256, mult_depth=22, secret_hamming=64, first_mod_bits=30)
SHAPE = dict(K=13.0, sin_degree=127, asin_terms=2)


def test_kway_sort_with_real_bootstrap_matches_jax():
    jctx = JContext(JParams(**PARAMS))
    jkeys = JKeys.generate(jctx, seed=0)
    jkeys.gen_conj_key()
    jev = JEvaluator(jctx, jkeys)
    jbs = JBootstrapper(jev, **SHAPE)
    jkeys.gen_rotation_keys(sorted(
        jbs.required_rotations() | {1 << i for i in range(8)} | {-(1 << i) for i in range(8)}))
    ctx = Context(CkksParams(**PARAMS), device="cpu")
    keys = Keys.from_numpy(
        ctx, jkeys.s_coeffs, jkeys.s_eval, jkeys.pk[0], jkeys.pk[1],
        np.asarray(jkeys.relin.kb), np.asarray(jkeys.relin.ka),
        rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jkeys.rot.items()})
    tev = Evaluator(ctx, keys)
    tbs = Bootstrapper(tev, **SHAPE)
    jfired, tfired = [], []

    def jfn(ct):
        jfired.append(ct.level)
        return jbs.bootstrap(ct)

    def tfn(ct):
        tfired.append(ct.level)
        return tbs.bootstrap(ct)

    N = 4
    x = vector_with_min_diff(N, seed=3)
    jct = jkeys.encrypt(x, slots=N, seed=1)
    ct = Ciphertext.from_numpy(np.asarray(jct.data), jct.level, jct.sdeg, jct.slots, "cpu")
    jcfg = jsign.SignConfig(jsign.CompositeSignConfig(3, 1, 1), mult_depth=PARAMS["mult_depth"])
    tcfg = tsign.SignConfig(tsign.CompositeSignConfig(3, 1, 1), mult_depth=PARAMS["mult_depth"])
    out = KWaySorter(tev, 2, 2, bootstrap_fn=tfn).sort(ct, tsign.SignFunc.CompositeSign, tcfg)
    jout = JKWaySorter(jev, 2, 2, bootstrap_fn=jfn).sort(jct, jsign.SignFunc.CompositeSign, jcfg)
    assert len(tfired) >= 1, "no bootstrap fired"
    assert tfired == jfired
    assert (out.level, out.sdeg, out.slots) == (jout.level, jout.sdeg, jout.slots)
    np.testing.assert_array_equal(out.data.numpy(), np.asarray(jout.data).astype(np.int64))
    assert np.abs(keys.decrypt(out, N) - np.sort(x)).max() < 0.01
