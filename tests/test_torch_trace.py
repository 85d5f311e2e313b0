"""The port's spans and counters (`core/trace.py`) on the CPU, and on the card.

A span is recorded only inside `trace.recording()` or while a
`torch.profiler` session records.  A staged sort's dispatch spans nest under
its sort's span and share its sort id, one per `StageTable.run` call; every
span enters the profiler's trace as an annotation on the same clock; and the
benchmark's readers of the new per-layer metrics find a positive value in the
spans of a profiled eager run of a tiny sort of their own kind.  On the card
(`-m cuda`, run with `--noconftest`: this file imports no JAX), a stage's
replays advance `Evaluator.ntt_planes` by the planes its capture took back,
and a dispatch span's device interval brackets the device work of its
copy-in, graph launch and clone-out.
"""

import bisect

import numpy as np
import pytest
import torch

from fhe_sorting_tpu_torch.core import trace
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig
from fhe_sorting_tpu_torch.parallel.direct_staged import StagedDirectSort, scan_rotation_indices
from fhe_sorting_tpu_torch.parallel.mehp24_staged import StagedMehp24Multi, mehp24_staged_keys
from fhe_sorting_tpu_torch.utils.depth_meter import MeterEvaluator, measure_direct_sort_depth
from portbench import harness

torch.set_num_threads(2)

# the stage groups of the per-layer metrics, by sort
GROUPS = {
    "direct": {"sign": lambda s: s.startswith("B"), "sinc": lambda s: s == "FG",
               "other": lambda s: s in {"A", "C0", "C", "D", "E", "H", "I"} or s.startswith("Esub")},
    "mehp24": {"cmp": lambda s: s == "cmp", "ind": lambda s: s == "ind" or s.startswith("Rsub"),
               "fold": lambda s: s in {"acc", "flip", "sv", "sh", "acc2", "align", "place"},
               "other": lambda s: s in {"split", "repl", "combine"}},
}
SORT_SPANS = {"direct": {"direct.construct_rank", "direct.index_check"},
              "mehp24": {"mehp24.sort"}}
READERS = [("mehp24.cmp_s", "mehp24"), ("mehp24.ind_s", "mehp24"), ("mehp24.fold_s", "mehp24"),
           ("direct.sign_s", "direct"), ("direct.sinc_s", "direct"),
           ("dispatch_host_us", "direct"), ("ntt_planes", "mehp24")]


def _sort(kind, device="cpu", graphs=None):
    """(sort, input) of a tiny sort: DirectSort of 4 values at ring 256, or
    MEHP24 of 8 values over two 4x4 tiles at ring 256."""
    ring = 256
    if kind == "direct":
        cfg = SignConfig(CompositeSignConfig(3, 3, 2))
        depth = measure_direct_sort_depth(4, ring, cfg)["mult_depth"]
        keys = Keys.generate(Context(CkksParams(ring_n=ring, mult_depth=depth), device=device),
                             seed=0)
        keys.gen_rotation_keys(sorted(scan_rotation_indices(4, ring)))
        vals = np.random.default_rng(0).permutation(4) / 4 + 0.125
        return (StagedDirectSort(Evaluator(keys.ctx, keys), 4, cfg, graphs=graphs),
                keys.encrypt(vals, seed=1))
    sign = (1, 1, 2, 1)
    meter = MeterEvaluator(ring)
    out = StagedMehp24Multi(meter, 8, 4, *sign)(Ciphertext(None, 0, 1, 16))
    depth = meter.max_level + (out.sdeg == 2)
    keys = Keys.generate(Context(CkksParams(ring_n=ring, mult_depth=depth), device=device), seed=0)
    keys.gen_rotation_keys(sorted(mehp24_staged_keys(4, ring)))
    pad = np.zeros(16)
    pad[:8] = np.random.default_rng(0).permutation(8) / 8 + 0.0625
    return (StagedMehp24Multi(Evaluator(keys.ctx, keys), 8, 4, *sign, graphs=graphs),
            keys.encrypt(pad, slots=16, seed=1))


def _annotations(prof) -> dict:
    """name -> sorted [(start ns, end ns)] of the profiler's host events."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return {k: sorted(v) for k, v in out.items()}


def _off_clock(spans, events) -> tuple:
    """(median, 99th percentile) of the nanoseconds between each span's host
    interval and the nearest event of its name.  A thread preempted between
    the span's clock read and the profiler's (the suite runs six workers on
    fewer cores) puts a rare span milliseconds off, so the test reads
    quantiles, not the largest."""
    off = []
    for sp in spans:
        got = events[sp.name]
        i = bisect.bisect_left(got, (sp.start, sp.end))
        off.append(min(max(abs(s - sp.start), abs(e - sp.end)) for s, e in got[max(0, i - 2):i + 2]))
    off.sort()
    return off[len(off) // 2], off[int(0.99 * (len(off) - 1))]


@pytest.fixture(scope="module")
def profiled():
    """kind -> one profiled eager sort of that kind: its sort, spans,
    annotations and the seven readers' values read right after it."""
    cache = {}

    def get(kind):
        if kind not in cache:
            srt, ct = _sort(kind)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                srt(ct)
            run = harness.Run({"params": {}})
            # a traced run on the card: one profiled sort, a device trace
            run.traced_sorts, run.trace = 1, {"busy_s": 1.0}
            values = {name: harness.reader(name).read(run) for name, _ in READERS}
            cache[kind] = dict(srt=srt, spans=trace.spans(), events=_annotations(prof),
                               values=values)
        return cache[kind]
    return get


def test_a_span_outside_a_window_records_nothing():
    ctx = Context(CkksParams(ring_n=64, mult_depth=2), device="cpu")
    keys = Keys.generate(ctx, seed=0)
    ev = Evaluator(ctx, keys)
    ct = keys.encrypt(np.arange(8) / 8.0, seed=0)
    with trace.recording():
        ev.add(ct, ct)
    before = trace.spans()
    assert [s.name for s in before] == ["ev.add"]
    with trace.span("outside", ctx.device) as sp:
        ev.rescale(ev.mult(ct, ct))
    assert sp is None
    assert [s.name for s in trace.spans()] == ["ev.add"]


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_records_in_a_window_and_under_the_profiler(how):
    ctx = Context(CkksParams(ring_n=64, mult_depth=2), device="cpu")
    keys = Keys.generate(ctx, seed=0)
    ev = Evaluator(ctx, keys)
    ct = keys.encrypt(np.arange(8) / 8.0, seed=0)
    window = trace.recording() if how == "recording" else torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with window:
        with trace.span("outer", ctx.device) as outer:
            ev.mult(ct, ct)
    got = trace.spans()
    assert [s.name for s in got] == ["outer", "ev.mult", "ev.mult_ct", "ev.modup",
                                     "ev.inner_product", "ev.moddown"]
    assert got[0] is outer and outer.parent is None and outer.device == (outer.start, outer.end)
    assert all(s.sort == outer.sort for s in got)
    assert got[1].parent == outer.id and got[2].parent == got[1].id
    assert all(s.device is None and s.start <= s.end for s in got[1:])


@pytest.mark.parametrize("kind", ["direct", "mehp24"])
def test_stage_spans_nest_under_their_sort_span(profiled, kind):
    got = profiled(kind)
    srt, spans = got["srt"], got["spans"]
    by_id = {s.id: s for s in spans}
    dispatches = [s for s in spans if "kind" in s.counts]
    # one span per StageTable.run call, each an eager dispatch
    assert len(dispatches) == sum(st.calls for st in srt.stages.values())
    assert {s.name for s in dispatches} == {f"{kind}.{n}" for n in srt.stages}
    for s in dispatches:
        parent = by_id[s.parent]
        assert parent.name in SORT_SPANS[kind] and parent.parent is None
        assert s.sort == parent.sort and s.counts["kind"] == "eager"
        # every registered kernel's launches, none of them on the CPU
        assert list(s.counts) == ["kind", "planes", "k1", "k2", "k3", "k4", "ops"]
        assert all(s.counts[k] == 0 for k in ("k1", "k2", "k3", "k4"))
        assert s.counts["ops"] == sum(srt.stages[s.name.split(".", 1)[1]].op_counts.values())
        # on the CPU the device interval is the host interval
        assert s.device == (s.start, s.end)
    assert sum(s.counts["planes"] for s in dispatches) > 0
    # every stage falls in exactly one of the metric groups (or "other")
    for s in dispatches:
        stage = s.name.split(".", 1)[1]
        assert sum(g(stage) for g in GROUPS[kind].values()) == 1, stage
    assert all(any(g(n) for n in srt.stages) for g in GROUPS[kind].values())
    # the ops' spans lie under the stages' and share the sort ids
    ops = [s for s in spans if s.name.startswith("ev.")]
    assert ops and all(s.sort == by_id[s.parent].sort for s in ops)


@pytest.mark.parametrize("kind", ["direct", "mehp24"])
def test_spans_lie_on_the_profilers_clock(profiled, kind):
    """The spans' host intervals within 1 ms of their own annotations in the
    profiler's events, their median within 0.1 ms (the card test holds
    them to 50 us)."""
    got = profiled(kind)
    median, p99 = _off_clock(got["spans"], got["events"])
    assert median < 100_000 and p99 < 1_000_000, (median, p99)


@pytest.mark.parametrize("name,kind", READERS)
def test_reader_reads_the_program_spans(profiled, name, kind):
    value = profiled(kind)["values"][name]
    assert value is not None and value > 0


def test_readers_read_nothing_without_a_device_trace(profiled):
    """Off the card the harness's trace holds no device work, and the
    program's spans give no device metric (the tiny cell's traced run)."""
    profiled("direct")
    run = harness.Run({"params": {}})
    run.traced_sorts = 1
    assert all(harness.reader(name).read(run) is None for name, _ in READERS)


@pytest.mark.cuda
def test_dispatch_spans_on_card():
    """On graphs: one capture and k replays advance `ntt_planes` by (1 + k)
    times the eager dispatch's planes; each replay's device interval holds
    the device work its copy-in, graph launch and clone-out started, and
    ends within 50 us of it; the spans' host intervals lie within 50 us of
    their annotations; an eager sort's
    kernels are charged to evaluator ops through the correlation ids."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs need a CUDA device")
    from fhe_sorting_tpu_torch.utils import profile_sort

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    eager, ct = _sort("direct", "cuda", graphs=False)
    ev = eager.ev
    eager(ct)                                  # memos filled
    with trace.recording():
        eager(ct)
    planes = {s.name: s.counts["planes"] for s in trace.spans() if "kind" in s.counts}
    with torch.profiler.profile(activities=acts) as prof:
        eager(ct)
        torch.cuda.synchronize()
    census = profile_sort.op_census(prof, trace.spans())
    total = sum(census.values())
    assert sum(v for (op, _), v in census.items() if op.startswith("ev.")) > 0.9 * total

    graphs = StagedDirectSort(ev, 4, eager.cfg)
    k = 3
    ev.ntt_planes.clear()
    with trace.recording():
        for _ in range(1 + k):
            graphs(ct)
    torch.cuda.synchronize()
    spans = [s for s in trace.spans() if "kind" in s.counts]
    assert ev.ntt_planes.total() == (1 + k) * sum(planes.values())
    for s in spans:
        assert s.counts["planes"] == planes[s.name], s
    assert {s.counts["kind"] for s in spans} == {"capture", "replay"}

    with torch.profiler.profile(activities=acts) as prof:
        graphs(ct)
        torch.cuda.synchronize()
    spans = trace.spans()
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    assert _off_clock(spans, _annotations(prof))[1] < 50_000
    # each dispatch's device work: the device ops of the runtime calls it made
    calls = [(e.start_ns(), e.correlation_id()) for e in events
             if e.device_type() != cuda and e.name().startswith("cu") and e.correlation_id()]
    ops = {}
    for e in events:
        if e.device_type() == cuda and not e.is_user_annotation() \
                and e.name() not in {s.name for s in spans}:
            ops.setdefault(e.correlation_id(), []).append((e.start_ns(), e.end_ns()))
    checked, prev_last = 0, None
    for s in spans:
        if s.counts.get("kind") != "replay":
            continue
        got = [iv for t, c in calls if s.start <= t <= s.end for iv in ops.get(c, [])]
        if not got:
            continue
        first, last = min(a for a, _ in got), max(b for _, b in got)
        d0, d1 = s.device
        # the interval holds the copy-in, the graph's kernels and the clone-out
        # and ends with them; it opens once the stream has done the dispatch
        # before it, and any time the device then waits for the host is in it
        assert first >= d0 - 50_000 and abs(d1 - last) < 50_000, (s, d0 - first, d1 - last)
        assert prev_last is None or d0 >= prev_last - 50_000, (s, d0 - prev_last)
        prev_last = last
        checked += 1
    assert checked >= len(graphs.stages) - 2
