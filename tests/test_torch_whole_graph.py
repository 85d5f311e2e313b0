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
    from fhe_sorting_tpu_torch.core import bf_ntt, fs_ntt, ntt, ntt_mxu, primes

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
    before = (bf_ntt.launches, fs_ntt.launches)
    with torch.cuda.graph(g):
        o2, o1 = eager(buf)
    assert (bf_ntt.launches - before[0], fs_ntt.launches - before[1]) == (1, 2)
    for y in (x, planes()):
        buf.copy_(y)
        g.replay()
        want2, want1 = eager(y)
        torch.cuda.synchronize()
        assert torch.equal(o2, want2) and torch.equal(o1, want1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,ring,sign", [
    ("staged", 8, 512, (3, 2, 2)), ("scan", 8, 512, (3, 2, 2)), ("scan", 16, 64, (3, 3, 2))])
def test_sorts_on_graphs_equal_eager_on_card(kind, n, ring, sign):
    """The staged and scan sorts on graphs against the same sorts run
    eagerly on the card: equal planes on two inputs, and the replays' K2
    tallies equal to the eager launches."""
    _card()
    from fhe_sorting_tpu_torch.core import bf_ntt
    from fhe_sorting_tpu_torch.parallel.direct_scan import ScanDirectSort

    cls = StagedDirectSort if kind == "staged" else ScanDirectSort
    cfg = SignConfig(CompositeSignConfig(*sign))
    depth = measure_direct_sort_depth(n, ring, cfg)["mult_depth"] + 1
    ctx = Context(CkksParams(ring_n=ring, mult_depth=depth, ntt_impl="butterfly"))
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys(sorted(scan_rotation_indices(n, ring)))
    ev = Evaluator(ctx, keys)
    eager, graphs = cls(ev, n, cfg, graphs=False), cls(ev, n, cfg)
    rng = np.random.default_rng(5)
    graphs(keys.encrypt(rng.permutation(n) / n, seed=1))          # eager runs and captures
    for seed in (2, 3):
        vals = rng.permutation(n) / n + 0.5 / n
        ct = keys.encrypt(vals, seed=seed)
        before = bf_ntt.launches
        want = eager(ct)
        torch.cuda.synchronize()
        mid = bf_ntt.launches
        got = graphs(ct)
        torch.cuda.synchronize()
        assert torch.equal(got.data, want.data)
        assert bf_ntt.launches - mid == mid - before > 0
        assert float(np.abs(keys.decrypt(got, n) - np.sort(vals)).max()) < 0.01


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
