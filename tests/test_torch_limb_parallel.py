"""Limb-axis tensor parallelism in the PyTorch port, at two and three gloo ranks.

The cases of tests/test_limb_parallel.py and more: with the ciphertext limb
planes and the key rows distributed over a "limb" axis of two or three
ranks (spawned through `utils.multichip.spawn`, a `file://` store, no
network; three ranks split the 8 limbs 3, 3, 2), every op that mixes limbs
is bit-equal to the plain evaluator and to the JAX package's evaluator on
the same (JAX) keys and ciphertexts: mult + rescale, rotate, square,
conjugate, `adjust_level`, three hoisted rotations over one precompute,
`combo`, and mult + rescale on a chain of two primes a level (its two
dropped limbs on two ranks).  A limb-local add leaves its output sharded,
each rank holding its own rows; a stack of ciphertexts over a (R x 1)
("batch", "limb") mesh multiplies correctly; and the ops run as a stage
(`parallel/whole_graph.py`), their collectives inside it.  The work is
split, not repeated: each rank holds only its rows of every key, its ModUp
transforms only its own rows and target rows, a key switch gathers only
the digit and special coefficient planes (Ll*n + 2*K*n residues) and a
rescale broadcasts only the dropped limb; `LimbParallelEvaluator` adds no
op of its own beyond those hooks.  The card's entry for the sharded sort
(`multichip.run_limb_sort`) gives one rank's planes at two ranks, each
holding and transforming about half."""

import json

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.parallel import limb_parallel
from fhe_sorting_tpu_torch.parallel.limb_parallel import LimbParallelEvaluator
from fhe_sorting_tpu_torch.parallel.mesh import LimbLayout, block
from fhe_sorting_tpu_torch.utils import multichip

torch.set_num_threads(2)

RING = 256
# mult_depth 6 + 2 base limbs = 8 fresh limbs; dnum 3: 3 special primes
PARAMS = dict(ring_n=RING, mult_depth=6)
# two primes a level: 8 limbs, dnum 2: 4 special primes
PARAMS2 = dict(ring_n=RING, mult_depth=3, scale_bits=56, comp=2, base_limbs=2, dnum=2)
ROWS, CONSTS = [[0.5, -0.25, 1.0], [1.5, 0.75, -2.0]], [0.125, 0.0]
HOISTED = (1, 2, 4)
CASES = ["mult_rescale", "rotate", "square", "conjugate", "adjust_level", "hoisted", "combo",
         "comp2_mult_rescale"]


def _keys_np(jkeys) -> dict:
    return dict(s_coeffs=jkeys.s_coeffs, s_eval=jkeys.s_eval, pk_b=jkeys.pk[0], pk_a=jkeys.pk[1],
                relin_kb=np.asarray(jkeys.relin.kb), relin_ka=np.asarray(jkeys.relin.ka),
                rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jkeys.rot.items()})


def _ct_np(c) -> tuple:
    return np.asarray(c.data), c.level, c.sdeg, c.slots


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's keys, ciphertexts and results for every case."""
    jctx = JContext(JParams(**PARAMS))
    jkeys = JKeys.generate(jctx, seed=0)
    jkeys.gen_rotation_keys(list(HOISTED))
    jkeys.gen_conj_key()
    jev = JEvaluator(jctx, jkeys, jit_ops=False)
    rng = np.random.default_rng(0)
    jcts = [jkeys.encrypt(rng.uniform(-1, 1, 128), seed=i) for i in range(4)]
    jctx2 = JContext(JParams(**PARAMS2))
    jkeys2 = JKeys.generate(jctx2, seed=0)
    jct2 = jkeys2.encrypt(rng.uniform(-1, 1, 128), seed=9)
    jev2 = JEvaluator(jctx2, jkeys2, jit_ops=False)
    c0, c1, c2, c3 = jcts
    jpre = jev.rotate_precompute(c0)
    ref = {"mult_rescale": jev.rescale(jev.mult(c0, c0)),
           "rotate": jev.rotate(c1, 1),
           "add": jev.add(c2, c2),
           "square": jev.square(c0),
           "conjugate": jev.conjugate(c1),
           "adjust_level": jev.adjust_level(c2, 2),
           "hoisted": [jev.rotate_hoisted(c0, jpre, r) for r in HOISTED],
           "combo": jev.combo([c0, jev.mult(c1, c1), c2], ROWS, CONSTS),
           "stack": jev.mult(c3, c3),
           "staged": jev.rotate(jev.rescale(jev.mult(c0, c0)), 1),
           "comp2_mult_rescale": jev2.rescale(jev2.mult(jct2, jct2))}

    def planes(v):
        if isinstance(v, list):
            return np.stack([np.asarray(c.data) for c in v]).astype(np.int64)
        return np.asarray(v.data).astype(np.int64)

    args = (CkksParams(**PARAMS), _keys_np(jkeys), [_ct_np(c) for c in jcts])
    comp2 = (CkksParams(**PARAMS2), _keys_np(jkeys2), _ct_np(jct2))
    return args, comp2, {k: planes(v) for k, v in ref.items()}, jctx


@pytest.fixture(scope="module", params=[2, 3], ids=["2ranks", "3ranks"])
def runs(request, jax_side, tmp_path_factory):
    """Each rank's results at `world` limb ranks, the JAX package's for the
    same inputs, the world and the JAX context."""
    world = request.param
    args, comp2, ref, jctx = jax_side
    out = str(tmp_path_factory.mktemp(f"limb{world}") / "rank")
    multichip.spawn(multichip.run_limb_parallel, world, (*args, out, None, comp2),
                    backend="gloo")
    ranks = [dict(np.load(f"{out}{r}.npz")) for r in range(world)]
    return ranks, ref, world, jctx


@pytest.mark.parametrize("case", CASES)
def test_limb_sharded_op_matches_plain_and_jax(runs, case):
    ranks, ref, _, _ = runs
    for r in ranks:
        np.testing.assert_array_equal(r[f"{case}_got"], r[f"{case}_ref"])
        np.testing.assert_array_equal(r[f"{case}_got"], ref[case])


def test_add_stays_sharded(runs):
    """A limb-local op must not replicate its output: each rank holds its
    own rows of the limbs, limb i on rank i mod R."""
    ranks, ref, world, jctx = runs
    L = jctx.limbs_at(0)
    for rank, r in enumerate(ranks):
        assert bool(r["stayed_sharded"])
        rows = list(range(rank, L, world))
        assert r["add_block_got"].shape[-2] == len(rows) < L
        np.testing.assert_array_equal(r["add_block_got"], ref["add"][:, rows])
        np.testing.assert_array_equal(r["add_got"], ref["add"])


def test_batch_by_limb_2d_mesh(runs):
    """(R x 1) ("batch", "limb") mesh: each rank multiplies its share of a
    stack of four ciphertexts, each product bit-equal to the plain one."""
    ranks, ref, world, _ = runs
    for rank, r in enumerate(ranks):
        assert r["stack_got"].shape[0] == len(block(4, world, rank))
        np.testing.assert_array_equal(r["stack_got"], r["stack_ref"])
        for got in r["stack_got"]:
            np.testing.assert_array_equal(got, ref["stack"])


def test_limb_ops_as_a_stage(runs):
    """mult + rescale + rotate on limb-sharded operands as one stage (the
    collectives inside it; eager on the CPU, where graphs by default are
    not asked for, so nothing is refused): bit-equal to the plain
    evaluator at both calls, the second inside the evaluator's frozen
    section, which records the reads of the distributed ops too; the
    stage's op tally is the plain ops' count."""
    ranks, ref, _, _ = runs
    for r in ranks:
        for case in ("staged", "staged_again"):
            np.testing.assert_array_equal(r[f"{case}_got"], r[f"{case}_ref"])
        np.testing.assert_array_equal(r["staged_got"], ref["staged"])
        assert str(r["stage_ops"]) == str(r["plain_ops"]) and "rot" in str(r["stage_ops"])
        assert bool(r["frozen_read_relin"])
        assert str(r["graphs_refused"]) == ""


def test_limb_ranks_hold_only_their_key_rows(runs):
    """Each rank holds its Q limbs (i mod R) and special primes (j mod R) of
    every key-switch key, nothing more: its key bytes are the whole key
    set's times its share of the Lq+K rows."""
    ranks, _, world, jctx = runs
    nq, nsp = jctx.num_q, len(jctx.sp_primes)
    held = []
    for rank, r in enumerate(ranks):
        want = (*range(rank, nq, world), *(nq + j for j in range(rank, nsp, world)))
        assert tuple(r["key_rows"]) == want == LimbLayout(nq, nsp, world, rank).key_rows()
        assert int(r["relin_rows"]) == len(want)
        assert int(r["key_bytes"]) * (nq + nsp) == int(r["whole_key_bytes"]) * len(want)
        held += want
    assert sorted(held) == list(range(nq + nsp))


@pytest.mark.parametrize("world", [2, 3])
def test_generated_key_rows_are_rows_of_the_whole_key(world):
    """The port's own key generation: every limb rank's rows of the
    relinearisation, rotation and conjugation keys, generated alone, are
    those rows of the key set generated whole from the same seed."""
    ctx = Context(CkksParams(**PARAMS), device="cpu")

    def generate(rows=None):
        keys = Keys.generate(ctx, seed=0, rows=rows)
        keys.gen_rotation_keys(list(HOISTED))
        keys.gen_conj_key()
        return keys

    whole = generate()
    held = []
    for rank in range(world):
        rows = LimbLayout(ctx.num_q, ctx.num_sp, world, rank).key_rows()
        part = generate(rows)
        assert part.rot.keys() == whole.rot.keys()
        for g, k in [(None, part.relin), *part.rot.items()]:
            w = whole.relin if g is None else whole.rot[g]
            assert k.kb.shape[1] == len(rows)
            torch.testing.assert_close(k.kb, w.kb[:, list(rows)], rtol=0, atol=0)
            torch.testing.assert_close(k.ka, w.ka[:, list(rows)], rtol=0, atol=0)
        held += rows
    assert sorted(held) == list(range(ctx.num_q + ctx.num_sp))


def test_modup_transforms_only_its_own_rows(runs):
    """One ModUp, counted where the plain NTT runs: each rank's INTT covers
    its own active rows and its NTT the dnum digits' own target rows."""
    ranks, _, world, jctx = runs
    Ll, nsp, dnum = jctx.limbs_at(0), len(jctx.sp_primes), 3
    for rank, r in enumerate(ranks):
        a, s = len(range(rank, Ll, world)), len(range(rank, nsp, world))
        assert r["modup_planes"].tolist() == [[1, a], [0, dnum * (a + s)]]


def test_key_switch_and_rescale_communicate_only_their_inputs(runs):
    """A key switch gathers the digit coefficient planes and the special
    coefficient planes, Ll*n + 2*K*n residues, and broadcasts nothing; a
    rescale broadcasts the dropped limb's [2, 1, n] plane and gathers
    nothing."""
    ranks, _, _, jctx = runs
    Ll, nsp = jctx.limbs_at(0), len(jctx.sp_primes)
    for r in ranks:
        assert int(r["ks_gathered"]) == Ll * RING + 2 * nsp * RING
        assert int(r["ks_broadcast"]) == 0
        assert int(r["rescale_broadcast"]) == 2 * RING and int(r["rescale_gathered"]) == 0


def test_limb_parallel_evaluator_adds_no_op_of_its_own():
    """No op gathers a whole ciphertext: the ops that mix limbs are the
    plain evaluator's own, run on a rank's rows through the hooks."""
    assert not hasattr(limb_parallel, "_gathered")
    for name in ("rescale", "_rescale_impl", "_rescale_data", "adjust_level", "level_reduce",
                 "rotate_precompute", "rotate_hoisted", "combo", "_keyswitch_core", "_modup",
                 "_inner_product", "_moddown", "mult", "square", "conjugate", "rotate_with_key"):
        assert getattr(LimbParallelEvaluator, name) is getattr(Evaluator, name), name


def test_card_entry_splits_the_sort(tmp_path):
    """`multichip.run_limb_sort`, the card's sharded DirectSort, rehearsed
    at ring 64 (N=8) on the CPU: two limb ranks give the planes of one, and
    each holds and transforms about half of one rank's key bytes and key
    switch and rescale planes."""
    res = {}
    for world in (1, 2):
        out = str(tmp_path / f"w{world}_")
        multichip.spawn(multichip.run_limb_sort, world, (8, out, 64), backend="gloo")
        res[world] = [dict(np.load(f"{out}{r}.npz")) for r in range(world)]
    one = res[1][0]
    assert float(one["err"]) < 0.01
    # the kernels' launches by name; none on the CPU
    assert json.loads(str(one["launches"])) == {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
    for r in res[2]:
        np.testing.assert_array_equal(r["data"], one["data"])
        assert tuple(r["meta"]) == tuple(one["meta"])
        assert int(r["key_bytes"]) <= 0.55 * int(one["key_bytes"])
        assert r["ks_planes"].sum() <= 0.55 * one["ks_planes"].sum()
        assert int(r["pt_planes"]) == int(one["pt_planes"]) > 0
