"""The PyTorch port's sharded sorts against the JAX package's.

Both packages compute on the same keys (the JAX keys, offset keys
included, carried across with `Keys.from_numpy`) and the same input
ciphertexts.  The port runs in-process over a one-rank gloo world and in
two gloo ranks spawned through `utils.multichip.spawn` (a `file://` store,
no network).

Tier-1: the key sets and offset keys match, and a rank that keeps some
offset keys gets them bit-equal to a rank that keeps all (two batch ranks
hold only their own, the JAX package's keys of their offsets); the
per-batch building blocks
of the sharded DirectSort (the offset rotation with the identity-galois
key, and one batch's masked-rotation sum) and of the sharded MEHP24 (the
replicate/transpose ladders, a pair's difference and the uniform rank fold)
are bit-equal to the JAX package's evaluator ops; and the port's sharded
sorts at two ranks (and on a 1 x 2 mesh with the limbs distributed, each
limb rank holding only its rows of every key) give the limb planes of its
one-rank run, decrypting within 0.01.  Both sharded
sorts run as stages (eager on the CPU): a second sort, inside the
evaluator's frozen section, gives the first sort's planes, the ranks'
agreement on the summed metadata is gathered at the first sort only, and
the stages' tallies (`phase_stats`) equal the ops the same program issues
run op by op.

Under `slow`: the whole sorts bit-equal to the JAX package's
`ShardedDirectSort` and `ShardedMehp24` on a one-device mesh, which are one
jitted program each and take minutes to compile on the CPU."""

import types
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu.models.direct_sort import DirectSort as JDirectSort
from fhe_sorting_tpu.models.mehp24.sort import Mehp24Sort as JMehp24Sort
from fhe_sorting_tpu.models.mehp24.utils import rotation_indices_mehp24 as j_mehp24_idx
from fhe_sorting_tpu.ops.sign import CompositeSignConfig as JCompositeSignConfig
from fhe_sorting_tpu.ops.sign import SignConfig as JSignConfig
from fhe_sorting_tpu.parallel import direct_sharded as jds
from fhe_sorting_tpu.utils.depth_meter import measure_direct_sort_depth as j_depth
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.models.mehp24.sort import Mehp24Sort
from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig
from fhe_sorting_tpu_torch.parallel import direct_sharded as tds
from fhe_sorting_tpu_torch.parallel.mehp24_sharded import ShardedMehp24
from fhe_sorting_tpu_torch.parallel.mesh import LimbLayout, init_world, make_mesh
from fhe_sorting_tpu_torch.utils import multichip
from fhe_sorting_tpu_torch.utils.params_registry import mehp24_indicator_cfg

torch.set_num_threads(2)

N, RING, CFG = 8, 64, (3, 3, 2)          # P=4, num_batch=2, np=2
SUB, PARTS, MEHP_DEPTH = 2, 2, 33


def _keys_np(jkeys) -> dict:
    return dict(s_coeffs=jkeys.s_coeffs, s_eval=jkeys.s_eval, pk_b=jkeys.pk[0], pk_a=jkeys.pk[1],
                relin_kb=np.asarray(jkeys.relin.kb), relin_ka=np.asarray(jkeys.relin.ka),
                rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jkeys.rot.items()})


def _ct_np(jct) -> tuple:
    return np.asarray(jct.data), jct.level, jct.sdeg, jct.slots


def _port(params, jkeys):
    ctx = Context(params, device="cpu")
    keys = Keys.from_numpy(ctx, **_keys_np(jkeys))
    return ctx, keys, Evaluator(ctx, keys)


def _spawned(tmp_path, fn, args) -> list:
    out = str(tmp_path / "rank")
    multichip.spawn(fn, 2, (*args, out), backend="gloo")
    return [np.load(f"{out}{r}.npz") for r in range(2)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A one-rank gloo world in this process."""
    init_world("gloo", 0, 1, str(tmp_path_factory.mktemp("world") / "init"))
    yield make_mesh()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def direct_env():
    jcfg = JSignConfig(JCompositeSignConfig(*CFG))
    depth = j_depth(N, RING, jcfg)["mult_depth"] + 1
    jctx = JContext(JParams(ring_n=RING, mult_depth=depth))
    jkeys = JKeys.generate(jctx, seed=0)
    jkeys.gen_rotation_keys(sorted(jds.rotation_indices_sharded(N, RING)))
    P = min(N, (RING // 2) // N)
    offsets = [b * P for b in range(N // P)]
    joff = jds.gen_offset_keys(jkeys, offsets)
    vals = np.random.default_rng(0).permutation(N) / N + 0.5 / N
    jct = jkeys.encrypt(vals, seed=0)
    return types.SimpleNamespace(jcfg=jcfg, depth=depth, jctx=jctx, jkeys=jkeys, P=P,
                                 offsets=offsets, joff=joff, vals=vals, jct=jct,
                                 params=CkksParams(ring_n=RING, mult_depth=depth))


@pytest.fixture(scope="module")
def direct_outs(direct_env, world, tmp_path_factory):
    """The port's sharded DirectSort: in-process over one rank, and spawned
    over two ranks (batches sharded) and over a 1 x 2 mesh (limbs sharded)."""
    e = direct_env
    ctx, keys, ev = _port(e.params, e.jkeys)
    one = tds.ShardedDirectSort(ev, N, SignConfig(CompositeSignConfig(*CFG)), mesh=world)(
        Ciphertext.from_numpy(*_ct_np(e.jct), "cpu"))
    runs = {}
    for shape in ((2,), (1, 2)):
        tmp = tmp_path_factory.mktemp("direct")
        runs[shape] = _spawned(tmp, multichip.run_sharded_direct,
                               (e.params, _keys_np(e.jkeys), _ct_np(e.jct), N, CFG, shape))
    return keys, one, runs


@pytest.mark.parametrize("n,ring", [(8, 64), (16, 64), (128, 1 << 17), (1024, 1 << 17)])
def test_rotation_indices_sharded_match_jax(n, ring):
    assert tds.rotation_indices_sharded(n, ring) == jds.rotation_indices_sharded(n, ring)


def test_gen_offset_keys_on_carried_keys_are_the_jax_keys(direct_env):
    e = direct_env
    _, keys, _ = _port(e.params, e.jkeys)
    held = set(keys.rot)
    got = tds.gen_offset_keys(keys, e.offsets)
    assert set(keys.rot) == held and 1 in held
    for k, jk in zip(got, e.joff):
        np.testing.assert_array_equal(k.kb.numpy(), np.asarray(jk.kb).astype(np.int64))
        np.testing.assert_array_equal(k.ka.numpy(), np.asarray(jk.ka).astype(np.int64))


def test_gen_offset_keys_identity_key_switches_to_s():
    ctx = Context(CkksParams(ring_n=RING, mult_depth=4), device="cpu")
    keys = Keys.generate(ctx, seed=0)
    x = np.random.default_rng(1).uniform(-1, 1, 32)
    ct = keys.encrypt(x, seed=0)
    k0, k4 = tds.gen_offset_keys(keys, [0, 4])
    assert keys.rot[1] is k0 and 1 not in Keys.generate(ctx, seed=0).rot
    ev = Evaluator(ctx, keys)
    np.testing.assert_allclose(keys.decrypt(ev.rotate_with_key(ct, 0, k0)), x, atol=1e-4)
    np.testing.assert_allclose(keys.decrypt(ev.rotate_with_key(ct, 4, k4)), np.roll(x, -4),
                               atol=1e-4)


@pytest.mark.parametrize("keeps", [[[0, 1]], [[2, 3]], [[3]], [[0, 1], [1, 2, 3]]],
                         ids=["first", "last", "one", "after_another"])
def test_gen_offset_keys_keeps_only_its_own(keeps, monkeypatch):
    """A rank that keeps some offset keys holds those alone and makes no
    other, each bit-equal to the key a rank that keeps all draws: the i-th
    key is the stream's i-th draw, also where earlier keys are held."""
    ctx = Context(CkksParams(ring_n=RING, mult_depth=4), device="cpu")
    offsets = [0, 4, 8, 12]
    ref = tds.gen_offset_keys(Keys.generate(ctx, seed=0), offsets)
    keys = Keys.generate(ctx, seed=0)
    held, made = set(keys.rot), []
    gen = Keys._gen_ksk
    monkeypatch.setattr(Keys, "_gen_ksk", lambda self, *a: made.append(1) or gen(self, *a))
    for keep in keeps:
        got = tds.gen_offset_keys(keys, offsets, keep=keep)
        for i, k in enumerate(got):
            if i in keep:
                assert torch.equal(k.kb, ref[i].kb) and torch.equal(k.ka, ref[i].ka)
            else:
                assert k is None
    kept = set().union(*keeps)
    assert set(keys.rot) - held == {ctx.galois_element_rot(offsets[i]) for i in kept}
    assert len(made) == len(kept)


@pytest.mark.parametrize("b", [0, 1])
def test_offset_rotation_and_masked_sum_match_jax(direct_env, world, b):
    """Batch b's offset rotation (b=0: the identity-galois key) and its
    masked-rotation sum against the JAX package's evaluator and DirectSort
    ops, as its sharded program composes them."""
    e = direct_env
    jev = JEvaluator(e.jctx, e.jkeys, jit_ops=False)
    jsrt = JDirectSort(jev, N)
    num_slots, np_ = N * e.P, 2
    jinp = e.jct.set_slots(num_slots)
    perm, ksk = jev._rot_args(e.jctx.galois_element_rot(b * e.P))
    ju = jev._automorphism_impl(jinp, perm, ksk, jev._dev)
    jbabies = [ju if i == 0 else jsrt.rot.rotate(ju, i) for i in range(np_)]
    jshifted = jsrt._vec_rots_opt(jbabies, e.P, num_slots, np_, 0)

    _, keys, ev = _port(e.params, e.jkeys)
    srt = tds.ShardedDirectSort(ev, N, SignConfig(CompositeSignConfig(*CFG)), mesh=world)
    inp = Ciphertext.from_numpy(*_ct_np(e.jct), "cpu").set_slots(num_slots)
    u = ev.rotate_with_key(inp, b * e.P, srt.off_keys[b])
    shifted = srt._masked_sum(u)
    for got, ref in ((u, ju), (shifted, jshifted)):
        assert (got.level, got.sdeg, got.slots) == (ref.level, ref.sdeg, ref.slots)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data).astype(np.int64))


@pytest.mark.parametrize("shape", [(2,), (1, 2)], ids=["batch2", "limb2"])
def test_sharded_direct_sort_ranks_equal_one_rank(direct_env, direct_outs, shape):
    keys, one, runs = direct_outs
    for r in runs[shape]:
        assert tuple(r["meta"]) == (one.level, one.sdeg, one.slots)
        np.testing.assert_array_equal(r["data"], one.data.numpy())
    err = np.abs(keys.decrypt(one, N) - np.sort(direct_env.vals)).max()
    assert err < 0.01


def _limb_rows(e, rank: int) -> list:
    """A rank's rows of a key on the 1 x 2 mesh."""
    return list(LimbLayout(e.jctx.num_q, e.jctx.num_sp, 2, rank).key_rows())


def test_batch_ranks_hold_only_their_offset_keys(direct_env, direct_outs):
    """At two batch ranks each holds the JAX package's offset key of its own
    batch and no other; on the 1 x 2 mesh both limb ranks hold both, each
    only its rows of them."""
    e = direct_env
    _, _, runs = direct_outs
    rot = {e.jctx.galois_element_rot(r) for r in tds.rotation_indices_sharded(N, RING)}
    g_off = [e.jctx.galois_element_rot(r) for r in e.offsets]
    for shape, mine in (((2,), lambda rank: [rank]), ((1, 2), lambda rank: [0, 1])):
        for rank, r in enumerate(runs[shape]):
            rows = _limb_rows(e, rank) if len(shape) == 2 else slice(None)
            assert list(r["off_batches"]) == mine(rank)
            assert set(r["held"]) == rot | {g_off[b] for b in mine(rank)}
            for i, b in enumerate(mine(rank)):
                np.testing.assert_array_equal(
                    r["off_kb"][i], np.asarray(e.joff[b].kb)[:, rows].astype(np.int64))
                np.testing.assert_array_equal(
                    r["off_ka"][i], np.asarray(e.joff[b].ka)[:, rows].astype(np.int64))


def test_limb_ranks_hold_only_their_key_rows(direct_env, direct_outs):
    """On the 1 x 2 mesh each limb rank holds its rows of every key, relin,
    rotation and offset keys alike (Q limb i and special prime j on rank
    i, j mod 2), and so about half the key bytes of a batch rank that
    holds the same keys whole."""
    e = direct_env
    _, _, runs = direct_outs
    dnum = np.asarray(e.jkeys.relin.kb).shape[0]
    whole = 2 * dnum * (e.jctx.num_q + e.jctx.num_sp) * RING * 8
    for rank, r in enumerate(runs[(1, 2)]):
        rows = _limb_rows(e, rank)
        assert list(r["key_rows"]) == rows
        n_keys = len(r["held"]) + 1                 # the rotation keys and relin
        assert int(r["key_bytes"]) == n_keys * 2 * dnum * len(rows) * RING * 8
        assert int(r["key_bytes"]) <= 0.55 * n_keys * whole
    assert sorted(_limb_rows(e, 0) + _limb_rows(e, 1)) == list(
        range(e.jctx.num_q + e.jctx.num_sp))
    for r in runs[(2,)]:
        assert len(r["key_rows"]) == 0 and int(r["key_bytes"]) == (len(r["held"]) + 1) * whole


def _stage_runs(make, run, ev):
    """Two sorts of the staged object `make()` (the second inside the
    evaluator's frozen section) counting `all_gather_object` calls, then
    the same program op by op on a second object, its ops tallied by phase
    (`phase_of(stage name)`): (first, second, gathers after each sort,
    op-by-op output, its tally by phase, the staged object)."""
    gathers = []
    real = dist.all_gather_object

    def counting(*a, **k):
        gathers.append(1)
        return real(*a, **k)

    srt = make()
    dist.all_gather_object = counting
    try:
        first = run(srt)
        after_first = len(gathers)
        with ev.frozen():
            second = run(srt)
    finally:
        dist.all_gather_object = real
    plain = make()
    by_phase = {ph: Counter() for ph in srt.phase_stats()}

    def op_by_op(name, fn, cts):
        ev.op_stats = Counter()
        out = fn(cts)
        by_phase[srt.phase_of(name)] += ev.op_stats
        return out

    plain._run = op_by_op
    out = run(plain)
    return first, second, (after_first, len(gathers)), out, by_phase, srt


@pytest.fixture(scope="module")
def direct_stages(direct_env, world):
    e = direct_env
    _, _, ev = _port(e.params, e.jkeys)
    ct = Ciphertext.from_numpy(*_ct_np(e.jct), "cpu")
    return _stage_runs(
        lambda: tds.ShardedDirectSort(ev, N, SignConfig(CompositeSignConfig(*CFG)), mesh=world),
        lambda srt: [srt(ct)], ev)


@pytest.fixture(scope="module")
def mehp_stages(mehp_env, world):
    e = mehp_env
    _, _, ev = _port(e.params, e.jkeys)
    parts = [Ciphertext.from_numpy(*_ct_np(p), "cpu") for p in e.jparts]
    return _stage_runs(lambda: ShardedMehp24(ev, SUB, PARTS, *e.cfg, mesh=world),
                       lambda srt: srt(parts), ev)


@pytest.mark.parametrize("kind", ["direct", "mehp"])
def test_second_sharded_sort_runs_frozen(kind, request):
    """Every stage of a second sort can be captured (it uploads, makes and
    frees nothing), and gives the first sort's planes and the op-by-op
    program's."""
    first, second, _, out, _, srt = request.getfixturevalue(f"{kind}_stages")
    for a, b, c in zip(first, second, out):
        assert torch.equal(a.data, b.data) and torch.equal(a.data, c.data)
    assert not srt.stages.graphs and not srt.ev.ctx.frozen


@pytest.mark.parametrize("kind", ["direct", "mehp"])
def test_agreement_gathered_once_per_sort_object(kind, request):
    """The host round trip that checks the ranks' metadata runs at the
    first sort's two merge points, and at no later sort."""
    _, _, gathers, _, _, _ = request.getfixturevalue(f"{kind}_stages")
    assert gathers == (2, 2)


@pytest.mark.parametrize("kind", ["direct", "mehp"])
def test_sharded_phase_stats_equal_op_counts(kind, request):
    """Each phase's stage tallies (per-dispatch tally times calls) over two
    sorts are twice the ops the same program issues run op by op."""
    _, _, _, _, by_phase, srt = request.getfixturevalue(f"{kind}_stages")
    stats = srt.phase_stats()
    assert set(stats) == set(by_phase) and all(by_phase.values())
    for phase, counts in by_phase.items():
        assert stats[phase] == counts + counts, phase
    assert srt.stage_stats() == sum(stats.values(), Counter())


@pytest.mark.slow
def test_sharded_direct_sort_matches_jax(direct_env, direct_outs):
    from fhe_sorting_tpu.parallel.mesh import make_mesh as j_make_mesh

    e = direct_env
    jev = JEvaluator(e.jctx, e.jkeys, jit_ops=False)
    jout = jds.ShardedDirectSort(jev, N, e.jcfg, mesh=j_make_mesh(1))(e.jct)
    _, one, runs = direct_outs
    assert (one.level, one.sdeg, one.slots) == (jout.level, jout.sdeg, jout.slots)
    np.testing.assert_array_equal(one.data.numpy(), np.asarray(jout.data).astype(np.int64))
    np.testing.assert_array_equal(runs[(2,)][0]["data"], np.asarray(jout.data).astype(np.int64))


# -- MEHP24 -------------------------------------------------------------------

@pytest.fixture(scope="module")
def mehp_env():
    total = SUB * PARTS
    jctx = JContext(JParams(ring_n=RING, mult_depth=MEHP_DEPTH))
    jkeys = JKeys.generate(jctx, seed=0)
    jkeys.gen_rotation_keys(sorted(j_mehp24_idx(SUB) | {1 << i for i in range(7)}
                                   | {-(1 << i) for i in range(7)}))
    vals = np.random.default_rng(0).permutation(total) / total + 0.5 / total
    jparts = []
    for i in range(PARTS):
        v = np.zeros(SUB * SUB)
        v[:SUB] = vals[i * SUB:(i + 1) * SUB]
        jparts.append(jkeys.encrypt(v, slots=SUB * SUB, seed=i))
    cfg = (2, 2, *mehp24_indicator_cfg(total))
    return types.SimpleNamespace(jctx=jctx, jkeys=jkeys, vals=vals, jparts=jparts, cfg=cfg,
                                 params=CkksParams(ring_n=RING, mult_depth=MEHP_DEPTH))


@pytest.fixture(scope="module")
def mehp_outs(mehp_env, world, tmp_path_factory):
    e = mehp_env
    ctx, keys, ev = _port(e.params, e.jkeys)
    parts = [Ciphertext.from_numpy(*_ct_np(p), "cpu") for p in e.jparts]
    one = ShardedMehp24(ev, SUB, PARTS, *e.cfg, mesh=world)(parts)
    ranks = _spawned(tmp_path_factory.mktemp("mehp"), multichip.run_sharded_mehp24,
                     (e.params, _keys_np(e.jkeys), [_ct_np(p) for p in e.jparts], SUB, e.cfg))
    return keys, one, ranks


def test_mehp24_blocks_match_jax(mehp_env):
    """The ladders of two parts, their difference (a pair's comparison
    input) and the rank fold over it with an all-zero Ch (part 0's, as the
    uniform program has it) against the JAX package's matrix ops; the sign
    itself, `ops.sign.sign_adv`, is held to the JAX package in
    tests/test_torch_sign.py, and the whole triangle in
    tests/test_torch_mehp24.py (`sort_fg_multi`)."""
    e = mehp_env
    jev = JEvaluator(e.jctx, e.jkeys, jit_ops=False)
    jmat = JMehp24Sort(jev, SUB * PARTS, sub_length=SUB).mat
    _, keys, ev = _port(e.params, e.jkeys)
    mat = Mehp24Sort(ev, SUB * PARTS, sub_length=SUB).mat
    p0, p1 = (Ciphertext.from_numpy(*_ct_np(p), "cpu") for p in e.jparts)
    jp0, jp1 = e.jparts
    r0, jr0 = mat.replicate_row(p0), jmat.replicate_row(jp0)
    c1 = mat.replicate_column(mat.transpose_row(p1, True))
    jc1 = jmat.replicate_column(jmat.transpose_row(jp1, True))
    d, jd = ev.sub(r0, c1), jev.sub(jr0, jc1)
    zero = d.with_data(torch.zeros_like(d.data))
    fold = ev.add(mat.sum_rows(d), mat.replicate_row(
        mat.transpose_column(mat.sum_columns(zero, True), True)))
    jzero = jd.with_data(jnp.zeros_like(jd.data))
    jfold = jev.add(jmat.sum_rows(jd), jmat.replicate_row(
        jmat.transpose_column(jmat.sum_columns(jzero, True), True)))
    for got, ref in ((r0, jr0), (c1, jc1), (d, jd), (fold, jfold)):
        assert (got.level, got.sdeg, got.slots) == (ref.level, ref.sdeg, ref.slots)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data).astype(np.int64))


def test_sharded_mehp24_two_ranks_equal_one_rank(mehp_env, mehp_outs):
    keys, one, ranks = mehp_outs
    for r in ranks:
        assert tuple(r["meta"]) == (one[0].level, one[0].sdeg, one[0].slots)
        np.testing.assert_array_equal(r["data"], np.stack([c.data.numpy() for c in one]))
    got = np.concatenate([keys.decrypt(c, SUB) for c in one])
    assert np.abs(got - np.sort(mehp_env.vals)).max() < 0.01


@pytest.mark.slow
def test_sharded_mehp24_matches_jax(mehp_env, mehp_outs):
    from fhe_sorting_tpu.parallel.mehp24_sharded import ShardedMehp24 as JShardedMehp24
    from fhe_sorting_tpu.parallel.mesh import make_mesh as j_make_mesh

    e = mehp_env
    jev = JEvaluator(e.jctx, e.jkeys, jit_ops=False)
    jout = JShardedMehp24(jev, SUB, PARTS, *e.cfg, mesh=j_make_mesh(1))(e.jparts)
    _, one, ranks = mehp_outs
    ref = np.stack([np.asarray(c.data).astype(np.int64) for c in jout])
    assert [(c.level, c.sdeg, c.slots) for c in one] == [(c.level, c.sdeg, c.slots) for c in jout]
    np.testing.assert_array_equal(np.stack([c.data.numpy() for c in one]), ref)
    np.testing.assert_array_equal(ranks[0]["data"], ref)
