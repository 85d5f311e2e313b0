"""Limb-axis tensor parallelism in the PyTorch port, at two gloo ranks.

The four cases of tests/test_limb_parallel.py: with the ciphertext limb
planes split over a two-rank "limb" axis (ranks spawned through
`utils.multichip.spawn`, a `file://` store, no network), mult + rescale
and rotate are bit-equal to the plain evaluator and to the JAX package's
evaluator on the same (JAX) keys and ciphertexts; a limb-local add leaves
its output sharded, each rank holding its own block; and a stack of
ciphertexts over a (2 x 1) ("batch", "limb") mesh multiplies correctly."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu_torch.core.context import CkksParams
from fhe_sorting_tpu_torch.parallel.mesh import block
from fhe_sorting_tpu_torch.utils import multichip

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank's results, and the JAX package's for the same inputs."""
    # mult_depth 6 + 2 base limbs = 8 fresh limbs, 4 a rank
    jctx = JContext(JParams(ring_n=256, mult_depth=6))
    jkeys = JKeys.generate(jctx, seed=0)
    jkeys.gen_rotation_keys([1, 2, 4])
    jev = JEvaluator(jctx, jkeys, jit_ops=False)
    rng = np.random.default_rng(0)
    xs = [rng.uniform(-1, 1, 128) for _ in range(4)]
    jcts = [jkeys.encrypt(x, seed=i) for i, x in enumerate(xs)]
    keys_np = dict(s_coeffs=jkeys.s_coeffs, s_eval=jkeys.s_eval, pk_b=jkeys.pk[0],
                   pk_a=jkeys.pk[1], relin_kb=np.asarray(jkeys.relin.kb),
                   relin_ka=np.asarray(jkeys.relin.ka),
                   rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jkeys.rot.items()})
    out = str(tmp_path_factory.mktemp("limb") / "rank")
    multichip.spawn(multichip.run_limb_parallel, 2,
                    (CkksParams(ring_n=256, mult_depth=6), keys_np,
                     [(np.asarray(c.data), c.level, c.sdeg, c.slots) for c in jcts], out),
                    backend="gloo")
    ranks = [dict(np.load(f"{out}{r}.npz")) for r in range(2)]
    ref = {"mult_rescale": jev.rescale(jev.mult(jcts[0], jcts[0])),
           "rotate": jev.rotate(jcts[1], 1),
           "add": jev.add(jcts[2], jcts[2]),
           "stack": jev.mult(jcts[3], jcts[3])}
    return ranks, {k: np.asarray(v.data).astype(np.int64) for k, v in ref.items()}, jctx


@pytest.mark.parametrize("case", ["mult_rescale", "rotate"])
def test_limb_sharded_op_matches_plain_and_jax(runs, case):
    ranks, ref, _ = runs
    for r in ranks:
        np.testing.assert_array_equal(r[f"{case}_got"], r[f"{case}_ref"])
        np.testing.assert_array_equal(r[f"{case}_got"], ref[case])


def test_add_stays_sharded(runs):
    """A limb-local op must not replicate its output: each rank holds its
    own block of the limbs."""
    ranks, ref, jctx = runs
    L = jctx.limbs_at(0)
    for rank, r in enumerate(ranks):
        assert bool(r["stayed_sharded"])
        blk = block(L, 2, rank)
        assert r["add_block_got"].shape[-2] == len(blk) < L
        np.testing.assert_array_equal(r["add_block_got"], ref["add"][:, blk.start:blk.stop])
        np.testing.assert_array_equal(r["add_got"], ref["add"])


def test_batch_by_limb_2d_mesh(runs):
    """(2 x 1) ("batch", "limb") mesh: each rank multiplies its half of a
    stack of four ciphertexts, each product bit-equal to the plain one."""
    ranks, ref, _ = runs
    for r in ranks:
        assert r["stack_got"].shape[0] == 2
        np.testing.assert_array_equal(r["stack_got"], r["stack_ref"])
        for got in r["stack_got"]:
            np.testing.assert_array_equal(got, ref["stack"])
