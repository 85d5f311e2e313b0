"""The port's CUDA-graph stage runner (`parallel/whole_graph.py`) on the CPU.

A capture records kernels without running them, so everything a stage
uploads, makes or frees must have happened before it: `Evaluator.frozen()`
holds a section to that, and these tests show that each kind of upload
raises inside it, and that a second staged sort, with every memo filled by
the first, runs whole inside it.  The stage bookkeeping (per-dispatch
tallies weighted by calls) must give the JAX package's `stage_stats` and
`phase_stats`; `tests/test_torch_direct_staged.py` holds them key for key at
N=8 on ring 512, this file holds the port's two sorts to twice one sort's.
CUDA graphs themselves need the card (`tests/test_torch_kernels.py`)."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu_torch.core.context import CkksParams, Context, FrozenError
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig
from fhe_sorting_tpu_torch.parallel.direct_staged import StagedDirectSort, scan_rotation_indices
from fhe_sorting_tpu_torch.parallel.whole_graph import StageTable, WholeGraph, use_graphs
from fhe_sorting_tpu_torch.utils.depth_meter import measure_direct_sort_depth

torch.set_num_threads(2)

N, RING = 8, 512
CFG = SignConfig(CompositeSignConfig(3, 2, 2))


@pytest.fixture(scope="module")
def env():
    depth = measure_direct_sort_depth(N, RING, CFG)["mult_depth"]
    ctx = Context(CkksParams(ring_n=RING, mult_depth=depth), device="cpu")
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys(sorted(scan_rotation_indices(N, RING)))
    vals = np.random.default_rng(0).permutation(N) / N + 0.5 / N
    return ctx, keys, vals


@pytest.fixture(scope="module")
def two_sorts(env):
    """A staged sort, then a second one of the same input inside `frozen()`."""
    ctx, keys, vals = env
    srt = StagedDirectSort(Evaluator(ctx, keys), N, CFG)
    ct = keys.encrypt(vals, seed=1)
    key_ids = {id(k) for k in keys.rot.values()}
    first = srt(ct)
    one_sort = (srt.stage_stats(), srt.phase_stats())
    with srt.ev.frozen() as reads:
        second = srt(ct)
    return srt, first, second, one_sort, (reads, key_ids)


def test_second_staged_sort_runs_frozen(env, two_sorts):
    """Every stage of a second sort can be captured: it uploads, makes and
    frees nothing, and gives the first sort's planes."""
    _, keys, vals = env
    srt, first, second, _, (reads, key_ids) = two_sorts
    assert torch.equal(first.data, second.data)
    assert float(np.abs(keys.decrypt(second, N) - np.sort(vals)).max()) < 0.01
    # what a graph of the sort would hold: memoised plaintexts, scalars and
    # combo residues, and the relinearisation and rotation keys
    assert any(r is keys.relin for r in reads)
    assert {id(r) for r in reads} >= key_ids
    assert not srt.ev.ctx.frozen and srt.ev._reads is None


def test_stage_tallies_weighted_by_calls(two_sorts):
    srt, _, _, (stats1, phases1), _ = two_sorts
    assert srt.stage_stats() == stats1 + stats1
    for phase, counts in srt.phase_stats().items():
        assert counts == phases1[phase] + phases1[phase], phase
    # normalised to one sort by stage D's calls: the first sort's tally
    assert srt.one_sort_stats() == phases1
    assert {name: st.calls for name, st in srt.stages.items()} == {
        "A": 2, "Bg0": 2, "Bg1": 2, "Bf0": 2, "Bf1s": 2, "C0": 2, "D": 2,
        "E": 2, "Esub0": 2, "FG": 2, "H": 2, "I": 2}
    # the tally of one dispatch, the evaluator's own counter untouched
    assert srt.stages["A"].op_counts[("rot", 0)] > 0
    assert not srt.ev.op_stats


@pytest.fixture
def frozen_env(env):
    ctx, keys, vals = env
    ev = Evaluator(ctx, keys)
    ct = keys.encrypt(vals, seed=2)
    ev.mult_plain_at(ct, vals)              # one plaintext in the memo
    return ev, ct


@pytest.mark.parametrize("what,op", [
    ("a plaintext memo miss", lambda ev, ct: ev.make_plaintext(np.arange(N) / 7.0, 0)),
    ("upload to the device", lambda ev, ct: ev.ctx.tensor([1, 2, 3])),
    ("a key generation", lambda ev, ct: ev.keys.gen_rotation_keys([3])),
    ("upload to the device", lambda ev, ct: ev.add(ct, 0.123)),           # a new scalar
    ("upload to the device", lambda ev, ct: ev.combo([ct], [[0.25]], [0.5])),
    ("upload to the device", lambda ev, ct: ev.ctx.galois_perm(ev.ctx.galois_element_rot(5))),
    ("a new limb index set", lambda ev, ct: ev.ctx.limbs_range(1, 2)),
])
def test_frozen_raises(frozen_env, what, op):
    ev, ct = frozen_env
    with pytest.raises(FrozenError, match=what):
        with ev.frozen():
            op(ev, ct)
    assert not ev.ctx.frozen
    op(ev, ct)                              # thawed again: the same call runs


def test_frozen_raises_on_eviction(frozen_env):
    ev, ct = frozen_env
    ev.make_plaintext(np.ones(N), 0)
    with pytest.raises(FrozenError, match="eviction"):
        with ev.frozen():
            ev.pt_cache_bytes = 0
            ev._evict()
    assert len(ev._pt_cache) == 2


def test_frozen_hits_are_recorded(frozen_env):
    ev, ct = frozen_env
    vals = np.random.default_rng(0).permutation(N) / N + 0.5 / N
    with ev.frozen() as reads:
        ev.mult_plain_at(ct, vals)
    pt = ev.make_plaintext(vals, 0, 1, slots=N)
    assert any(r is pt for r in reads)
    with pytest.raises(FrozenError, match="nest"):
        with ev.frozen():
            with ev.frozen():
                pass


def test_reused_stage_with_other_metadata_raises(env):
    ctx, keys, vals = env
    ev = Evaluator(ctx, keys)
    table = StageTable(ev)
    ct = keys.encrypt(vals, seed=3)
    out = table.run("S", lambda cts: ev.add(cts[0], 0.5), [ct])
    assert table["S"].calls == 1 and table["S"].op_counts == {("add", 0): 1}
    with pytest.raises(AssertionError, match="different ciphertext metadata"):
        table.run("S", lambda cts: ev.add(cts[0], 0.5), [ev.rescale(ev.mult(out, 2.0))])
    with pytest.raises(AssertionError, match="different ciphertext metadata"):
        table.run("S", lambda cts: ev.add(cts[0], 0.5), [ct.set_slots(2 * N)])
    assert table["S"].calls == 1


def test_graphs_need_a_cuda_context(env):
    ctx, keys, _ = env
    ev = Evaluator(ctx, keys)
    assert use_graphs(ev, None) is False and use_graphs(ev, False) is False
    with pytest.raises(ValueError, match="CUDA context"):
        StagedDirectSort(ev, N, CFG, graphs=True)
    with pytest.raises(ValueError, match="CUDA context"):
        WholeGraph(ev, lambda cts: cts[0], graph=True)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs and the kernels need a CUDA device")


@pytest.mark.cuda
def test_graph_replays_k1_and_k2_on_card():
    """One K2 cluster launch and one K1 pair captured in a graph: each replay
    equals an eager launch on the same planes, new data included."""
    _card()
    from fhe_sorting_tpu_torch.core import bf_ntt, cuda_build, fs_ntt, ntt, ntt_mxu, primes

    ring = 1 << 17
    n1, n2 = ntt_mxu.split_n(ring)
    ps = primes.ntt_primes(ring, 30, 4)
    bf = ntt.build_device_tables(ps, ring, "cuda")
    fs = ntt_mxu.build_fs_tables(ps, ring, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)

    def planes():
        return torch.remainder(torch.randint(0, 1 << 62, (2, 4, ring), generator=gen,
                                             device="cuda"), bf.p)

    def eager(x):
        return (bf_ntt.butterfly(x, bf, None, False),
                fs_ntt.four_step(x.reshape(2, 4, n1, n2), fs, None, False))

    x = planes()
    eager(x)                                   # the kernels' one-time set-up runs outside
    buf = x.clone()
    g = torch.cuda.CUDAGraph()
    before = cuda_build.counts()
    with torch.cuda.graph(g):
        o2, o1 = eager(buf)
    assert cuda_build.since(before) == {"k1": 2, "k2": 1, "k3": 0, "k4": 0}
    for y in (x, planes()):
        buf.copy_(y)
        g.replay()
        want2, want1 = eager(y)
        torch.cuda.synchronize()
        assert torch.equal(o2, want2) and torch.equal(o1, want1)


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A one-rank NCCL world over the card, for the sharded sorts."""
    _card()
    import torch.distributed as dist

    from fhe_sorting_tpu_torch.parallel.mesh import init_world, make_mesh

    init_world("nccl", 0, 1, str(tmp_path_factory.mktemp("world") / "init"))
    yield make_mesh()
    dist.destroy_process_group()


def _card_sort(kind, n, ring, sign, request):
    """(make(graphs), encrypt(vals, seed), decrypt(out, ...)) of one sort
    kind on a butterfly context on the card: `make(False)` runs eagerly,
    `make(None)` on graphs."""
    from fhe_sorting_tpu_torch.models.mehp24.utils import rotation_indices_mehp24
    from fhe_sorting_tpu_torch.parallel.direct_scan import ScanDirectSort
    from fhe_sorting_tpu_torch.parallel.direct_sharded import (
        ShardedDirectSort, rotation_indices_sharded)
    from fhe_sorting_tpu_torch.parallel.mehp24_sharded import ShardedMehp24

    if kind == "sharded_mehp24":
        ctx = Context(CkksParams(ring_n=ring, mult_depth=33, ntt_impl="butterfly"))
        keys = Keys.generate(ctx, seed=0)
        keys.gen_rotation_keys(sorted(rotation_indices_mehp24(2) | {1 << i for i in range(7)}
                                      | {-(1 << i) for i in range(7)}))
        mesh, ev = request.getfixturevalue("nccl_mesh"), Evaluator(ctx, keys)
        parts = n // 2

        def encrypt(vals, seed):
            out = []
            for i in range(parts):
                v = np.zeros(4)
                v[:2] = vals[2 * i:2 * i + 2]
                out.append(keys.encrypt(v, slots=4, seed=seed + i))
            return out

        return (lambda graphs: ShardedMehp24(ev, 2, parts, *sign, mesh=mesh, graphs=graphs),
                encrypt, lambda out: np.concatenate([keys.decrypt(c, 2) for c in out]))
    cfg = SignConfig(CompositeSignConfig(*sign))
    depth = measure_direct_sort_depth(n, ring, cfg)["mult_depth"] + 1
    ctx = Context(CkksParams(ring_n=ring, mult_depth=depth, ntt_impl="butterfly"))
    keys = Keys.generate(ctx, seed=0)
    ev = Evaluator(ctx, keys)
    if kind == "sharded_direct":
        keys.gen_rotation_keys(sorted(rotation_indices_sharded(n, ring)))
        mesh = request.getfixturevalue("nccl_mesh")

        def make(graphs):
            return ShardedDirectSort(ev, n, cfg, mesh=mesh, graphs=graphs)
    else:
        keys.gen_rotation_keys(sorted(scan_rotation_indices(n, ring)))
        cls = StagedDirectSort if kind == "staged" else ScanDirectSort

        def make(graphs):
            return cls(ev, n, cfg, graphs=graphs)
    return make, lambda vals, seed: keys.encrypt(vals, seed=seed), \
        lambda out: keys.decrypt(out, n)


def _planes(out):
    return torch.stack([c.data for c in out]) if isinstance(out, list) else out.data


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,ring,sign", [
    ("staged", 8, 512, (3, 2, 2)), ("scan", 8, 512, (3, 2, 2)), ("scan", 16, 64, (3, 3, 2)),
    ("sharded_direct", 16, 64, (3, 3, 2)), ("sharded_mehp24", 4, 64, (2, 2, 2, 2))])
def test_sorts_on_graphs_equal_eager_on_card(kind, n, ring, sign, request):
    """The staged, scan and sharded sorts on graphs against the same sorts
    run eagerly on the card: equal planes on two inputs, and the replays'
    launch tallies equal to the eager launches, K2's above 0 (the sharded
    sorts on a one-rank NCCL world, their all-reduces between the graphs)."""
    _card()
    from fhe_sorting_tpu_torch.core import cuda_build

    make, encrypt, decrypt = _card_sort(kind, n, ring, sign, request)
    eager, graphs = make(False), make(None)
    rng = np.random.default_rng(5)
    graphs(encrypt(rng.permutation(n) / n, 1))          # eager runs and captures
    if kind != "scan":
        assert graphs.stages.graph_count() == len(graphs.stages) > 0
    for seed in (2, 3):
        vals = rng.permutation(n) / n + 0.5 / n
        ct = encrypt(vals, seed)
        before = cuda_build.counts()
        want = eager(ct)
        torch.cuda.synchronize()
        launched, mid = cuda_build.since(before), cuda_build.counts()
        got = graphs(ct)
        torch.cuda.synchronize()
        assert torch.equal(_planes(got), _planes(want))
        assert cuda_build.since(mid) == launched and launched["k2"] > 0
        assert float(np.abs(decrypt(got) - np.sort(vals)).max()) < 0.01


@pytest.mark.cuda
def test_second_hybrid_sort_only_replays_on_card():
    """The staged hybrid sort of 8 values over two 4-wide tiles on graphs,
    twice from keys given once (its one key set, constructRank's and the
    placement's): the second sort's dispatches are all replays, its output
    equals the first's bit for bit, and it runs the NTT planes and the
    launches of every kernel of the same sort run eagerly on the warm
    evaluator (the first sort runs each stage eagerly before capturing it,
    and so also encodes the plaintexts its memo then keeps)."""
    _card()
    from fhe_sorting_tpu_torch.core import cuda_build, trace
    from fhe_sorting_tpu_torch.parallel.hybrid_staged import (
        StagedHybridSort, hybrid_rotation_indices)

    n, ring, tile = 8, 512, 4
    keys = Keys.generate(Context(CkksParams(ring_n=ring, mult_depth=38)), seed=0)
    keys.gen_rotation_keys(sorted(hybrid_rotation_indices(n, ring, tile)))
    ev, cfg = Evaluator(keys.ctx, keys), SignConfig(CompositeSignConfig(3, 3, 2))
    srt = StagedHybridSort(ev, n, cfg, max_array=tile, indicator_dg=2)
    eager = StagedHybridSort(ev, n, cfg, max_array=tile, indicator_dg=2, graphs=False)
    vals = np.random.default_rng(0).permutation(n) / n + 0.5 / n
    ct = keys.encrypt(vals, seed=1)
    runs = []
    for run in (srt, srt, eager):
        with trace.recording():
            out = run(ct)
            torch.cuda.synchronize()
        runs.append((out, [s for s in trace.spans() if "kind" in s.counts]))
    (first, d1), (second, d2), (want, d3) = runs
    assert "capture" in {s.counts["kind"] for s in d1}
    assert [s.name for s in d2] == [s.name for s in d1] == [s.name for s in d3]
    assert all(s.counts["kind"] == "replay" for s in d2)
    for what in ("planes", *cuda_build.KERNELS):
        assert sum(s.counts[what] for s in d2) == sum(s.counts[what] for s in d3), what
    assert sum(s.counts["planes"] for s in d2) > 0 and sum(s.counts["k3"] for s in d2) > 0
    assert srt.stages.graph_count() == len(srt.stages)
    assert torch.equal(first.data, second.data) and torch.equal(second.data, want.data)
    assert float(np.abs(keys.decrypt(second, n) - np.sort(vals)).max()) < 0.01


@pytest.mark.cuda
def test_failed_capture_raises_on_card():
    """A stage that uploads on every call cannot be captured: the call
    raises, and nothing falls back to eager."""
    _card()
    ctx = Context(CkksParams(ring_n=64, mult_depth=4, ntt_impl="butterfly"))
    keys = Keys.generate(ctx, seed=0)
    ev = Evaluator(ctx, keys)
    ct = keys.encrypt(np.arange(8) / 8.0, seed=0)
    calls = []

    def fresh_mask(cts):
        calls.append(1)
        return ev.mult_plain_at(cts[0], np.full(8, len(calls) / 10.0))

    with pytest.raises(FrozenError, match="plaintext memo miss"):
        WholeGraph(ev, fresh_mask)([ct])


@pytest.mark.cuda
def test_limb_ranks_share_the_card_under_gloo(tmp_path):
    """Two gloo ranks on one card (NCCL refuses two ranks on one GPU), the
    limbs and the key rows split between them at ring 2^12: every case of
    `multichip.run_limb_parallel` (the ops that mix limbs, on two chains)
    bit-equal to the plain evaluator of one rank, gloo moving the CUDA
    tensors through host memory; a key switch gathers Ll*n + 2*K*n
    residues; and a stage on graphs is refused, since a graph cannot
    capture a gloo collective."""
    _card()
    from fhe_sorting_tpu_torch.utils import multichip

    def keys_np(k):
        def pair(ksk):
            return ksk.kb.cpu().numpy(), ksk.ka.cpu().numpy()

        return dict(s_coeffs=k.s_coeffs, s_eval=k.s_eval, pk_b=k.pk[0], pk_a=k.pk[1],
                    relin_kb=pair(k.relin)[0], relin_ka=pair(k.relin)[1],
                    rot={g: pair(v) for g, v in k.rot.items()})

    def chain(**kw):
        params = CkksParams(ring_n=1 << 12, ntt_impl="butterfly", **kw)
        keys = Keys.generate(Context(params), seed=0)
        return params, keys

    rng = np.random.default_rng(0)
    params, keys = chain(mult_depth=6)
    keys.gen_rotation_keys([1, 2, 4])
    keys.gen_conj_key()
    cts = [keys.encrypt(rng.uniform(-1, 1, 128), seed=i) for i in range(4)]
    params2, keys2 = chain(mult_depth=3, scale_bits=56, comp=2, base_limbs=2, dnum=2)
    ct2 = keys2.encrypt(rng.uniform(-1, 1, 128), seed=9)

    def ct_np(c):
        return c.data.cpu().numpy(), c.level, c.sdeg, c.slots

    out = str(tmp_path / "rank")
    multichip.spawn(multichip.run_limb_parallel, 2,
                    (params, keys_np(keys), [ct_np(c) for c in cts], out, False,
                     (params2, keys_np(keys2), ct_np(ct2))),
                    backend="gloo", device="cuda:0")
    ctx = keys.ctx
    for rank in range(2):
        r = dict(np.load(f"{out}{rank}.npz"))
        got = [k for k in r if k.endswith("_got")]
        assert len(got) >= 12
        for k in got:
            np.testing.assert_array_equal(r[k], r[k[:-4] + "_ref"], err_msg=k)
        assert "cannot capture" in str(r["graphs_refused"])
        assert int(r["ks_gathered"]) == (ctx.num_q + 2 * ctx.num_sp) * (1 << 12)
