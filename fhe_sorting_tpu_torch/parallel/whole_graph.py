"""A staged sort's stages as captured CUDA graphs: the counterpart of `WholeJit`.

Port of `fhe_sorting_tpu/parallel/whole_jit.py`.  The JAX package compiles
each stage of a staged sort into one XLA program with the keys and tables
as arguments, so a stage is one dispatch.  Here a stage is one CUDA graph
(`torch.cuda.CUDAGraph`): its kernels (K1 or K2 for every NTT, K3 for the
rescales' and ModDown's divisions, K4 for the base extensions, PyTorch's
elementwise kernels) are captured once and
replayed, so a stage costs one graph launch instead of thousands of kernel
launches from Python.

`WholeGraph(ev, call)`, for `call(list[Ciphertext]) -> Ciphertext |
list[Ciphertext]` (an input may also be a `Plaintext` that differs between
calls, as the JAX package passes a sharded step its checking vectors):

  * the first call runs `call` eagerly, which fills the evaluator's memos
    and the context's caches, then captures it on fixed input buffers
    inside `ev.frozen()`, where an upload, a memo miss or eviction, a new
    cache entry or a key generation raises;
  * later calls copy the inputs into the buffers, replay, and clone the
    outputs out: the next replay overwrites the graph's own outputs, and a
    sort keeps stage outputs across replays (a carry fed back, a batch's
    result kept to the end);
  * a reused stage must get the same (level, sdeg, slots) metadata;
  * the graph holds every memoised tensor and key-switch key its capture
    read, as `WholeJit` takes keys as arguments, so no memo eviction frees
    what a replay reads.  Where a key it read is no longer one of the
    evaluator's (the key set was changed under it), the graph is dropped
    and the call runs as a first call again;
  * `op_counts` is the capture's per-dispatch op tally (the evaluator's
    `op_stats` is restored after it, as `WholeJit` restores it after its
    abstract pass) and `calls` counts dispatches.  The launch counter of
    `core/cuda_build.py` and the evaluator's `ntt_planes` count what the
    kernels really ran: the capture's launches and planes are taken back,
    and added again at every replay;
  * every dispatch is one span of `core/trace.py`, named `<sort>.<stage>`
    (the `StageTable`'s prefix), whose device interval brackets the
    copy-in, the replay and the clone-out (or the eager call) and whose
    counts are its `kind` ("eager", "capture": the first call on graphs,
    or "replay"), the NTT `planes`, the launches it ran of every kernel
    `cuda_build.KERNELS` registers (`k1` to `k4`), and the `ops` of its
    tally; a capture is a child span `<sort>.<stage>.capture` without a
    device interval;
  * nothing falls back: on a CUDA context a failed capture raises.

Streams and memory: the graphs of one sort share a `GraphSet`, one side
stream and one memory pool.  Every call runs on the side stream, which
first waits for the caller's stream; the caller's stream then waits for it.
The caller's stream is idle in between, so a block freed on either stream
is reused only after the work that read it.  Sharing the pool is safe
here: the pool's graphs replay one at a time on one stream, their input
buffers lie outside the pool, and every output is cloned right after its
replay, before another graph of the pool runs.  One graph's scratch may
then overlap another's scratch and outputs, never a tensor read later.
The pool holds the largest working set among the sort's stages plus every
graph's outputs, not the sum of the working sets.

On a CPU context, or with `graph=False`, a call runs `call` eagerly with
the same bookkeeping.
"""

from __future__ import annotations

import time
import warnings
from collections import Counter
from contextlib import contextmanager
from dataclasses import replace

import torch

from ..core import cuda_build, trace
from ..core.cipher import Ciphertext
from ..core.keys import KeySwitchKey


def use_graphs(ev, graphs: bool | None) -> bool:
    """Whether a sort on `ev` runs on graphs: `None` means yes on a CUDA
    context and no elsewhere; `True` on a CPU context raises, and so does
    asking for graphs (`None` or `True`) on a CUDA context whose evaluator
    runs collectives a graph cannot capture (a limb-parallel evaluator
    over gloo: `capturable`)."""
    on_cuda = getattr(getattr(ev.ctx, "device", None), "type", None) == "cuda"
    if graphs and not on_cuda:
        raise ValueError("CUDA graphs need a CUDA context")
    use = on_cuda if graphs is None else bool(graphs)
    if use and not getattr(ev, "capturable", True):
        raise ValueError("a CUDA graph cannot capture this evaluator's collectives "
                         "(gloo): pass graphs=False")
    return use


class GraphSet:
    """The side stream and the memory pool the graphs of one sort share."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()

    @contextmanager
    def bracket(self):
        """Run the body on the side stream, ordered after the caller's
        stream's work so far, and order the caller's stream after it."""
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        try:
            with torch.cuda.stream(self.stream):
                yield
        finally:
            caller.wait_stream(self.stream)


def _meta(cts) -> tuple:
    return tuple((type(c).__name__, c.level, c.sdeg, c.slots) for c in cts)


def _flat(out) -> list:
    return [out] if isinstance(out, Ciphertext) else list(out)


class WholeGraph:
    """`call(list[Ciphertext])` as one captured CUDA graph (see the module
    docstring); eager where `graph` is false."""

    def __init__(self, ev, call, graph: bool | None = None, graph_set: GraphSet | None = None,
                 name: str = "stage"):
        self.ev = ev
        self.call = call
        self.name = name           # the dispatch span's name
        self.graph = use_graphs(ev, graph)
        self.graph_set = graph_set
        self.calls = 0             # dispatches
        self.op_counts: dict = {}  # per-dispatch logical-op tally
        self.capture_s = 0.0       # host seconds spent capturing
        self._in_meta = None
        self._drop()

    def tally(self) -> Counter:
        """The op tally over all calls so far: one dispatch's times `calls`,
        as the reference weights a `WholeJit`'s."""
        return Counter({k: v * self.calls for k, v in self.op_counts.items()})

    def _drop(self):
        self._g = None
        self._ins = self._outs = self._single = None
        self._held = ()
        self._keys = ()
        self._launches = {}
        self._planes = Counter()

    def __call__(self, cts):
        if not isinstance(cts, (list, tuple)):
            cts = [cts]
        got = _meta(cts)
        if self._in_meta is None:
            self._in_meta = got
        assert got == self._in_meta, (
            f"stage reused with different ciphertext metadata: built for "
            f"{self._in_meta}, called with {got} - align inputs or use a "
            f"separate stage name")
        self.calls += 1
        if not self.graph:
            return self._dispatch("eager", self._eager, cts)
        if self.graph_set is None:
            self.graph_set = GraphSet(self.ev.ctx.device)
        with self.graph_set.bracket():
            if self._g is not None and self._keys_current():
                return self._outputs(self._dispatch("replay", self._replay, cts))
            self._drop()
            return self._dispatch("capture", self._first, cts)

    def _first(self, cts):
        out = self._eager(cts)
        self._capture(cts)
        return out

    def _dispatch(self, kind: str, run, cts):
        """`run(cts)` inside the dispatch's span, on the current stream (the
        side stream on graphs), with what it ran counted on the span once it
        has closed: no host work lies between the dispatch's last device
        work and the end of its device interval."""
        with trace.span(self.name, self.ev.ctx.device) as sp:
            if sp is None:
                return run(cts)
            planes = self.ev.ntt_planes.total()
            launched = cuda_build.counts()
            out = run(cts)
        sp.counts.update(kind=kind, planes=self.ev.ntt_planes.total() - planes,
                         **cuda_build.since(launched), ops=sum(self.op_counts.values()))
        return out

    def _eager(self, cts):
        ev = self.ev
        ev.op_stats, saved = Counter(), ev.op_stats
        try:
            out = self.call(list(cts))
            self.op_counts = dict(ev.op_stats)
        finally:
            ev.op_stats = saved
        return out

    def _keys_current(self) -> bool:
        keys = self.ev.keys
        live = {id(k) for k in keys.rot.values()} | {id(keys.relin)}
        return all(id(k) in live for k in self._keys)

    def _capture(self, cts):
        ev, gs = self.ev, self.graph_set
        ins = [replace(c, data=torch.empty_like(c.data, memory_format=torch.contiguous_format))
               for c in cts]
        for buf, c in zip(ins, cts):
            buf.data.copy_(c.data)
        g = torch.cuda.CUDAGraph()
        launched = cuda_build.counts()
        planes = Counter(ev.ntt_planes)
        ev.op_stats, saved = Counter(), ev.op_stats
        # the capture synchronizes first: the eager call's device work is
        # not the capture's time
        torch.cuda.synchronize(gs.device)
        t0 = time.perf_counter()
        try:
            with trace.span(f"{self.name}.capture"), ev.frozen() as reads, \
                    warnings.catch_warnings():
                # a stage of metadata-only ops (a rotation by 0, SetSlots)
                # captures no kernel: an empty graph is right there
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                # thread_local: a call of another thread (NCCL's watchdog
                # querying a collective's event) must not invalidate it
                with torch.cuda.graph(g, pool=gs.pool, stream=gs.stream,
                                      capture_error_mode="thread_local"):
                    out = self.call(list(ins))
        finally:
            self.op_counts = dict(ev.op_stats)
            ev.op_stats = saved
            self._launches = cuda_build.since(launched)
            cuda_build.advance(self._launches, -1)   # the capture launched nothing
            self._planes = ev.ntt_planes - planes
            ev.ntt_planes.subtract(self._planes)     # and transformed nothing
        self.capture_s += time.perf_counter() - t0
        self._g, self._ins = g, ins
        self._single = isinstance(out, Ciphertext)
        self._outs = _flat(out)
        self._held = tuple(reads)       # kept alive for the replays, never read
        self._keys = tuple(r for r in reads if isinstance(r, KeySwitchKey))

    def _replay(self, cts):
        """Copy-in, replay and clone-out; returns the outputs' planes, which
        `_outputs` wraps once the dispatch's span has closed."""
        cuda_build.advance(self._launches)
        self.ev.ntt_planes.update(self._planes)
        for buf, c in zip(self._ins, cts):
            buf.data.copy_(c.data)
        self._g.replay()
        return [o.data.clone() for o in self._outs]

    def _outputs(self, planes):
        outs = [replace(o, data=d) for o, d in zip(self._outs, planes)]
        return outs[0] if self._single else outs


class StageTable(dict):
    """The named stages of one sort, name -> `WholeGraph`, sharing one
    `GraphSet` where they run on graphs (`use_graphs(ev, graphs)`); the
    stage `name`'s dispatches are the spans `<prefix>.<name>`, the prefix
    naming the sort."""

    def __init__(self, ev, graphs: bool | None = None, prefix: str = "stage"):
        super().__init__()
        self.ev = ev
        self.graphs = use_graphs(ev, graphs)
        self.graph_set = None
        self.prefix = prefix

    def run(self, name: str, fn, cts):
        """`fn(cts)` as the stage `name` (the first `fn` given a name is the
        one its graph captures)."""
        st = self.get(name)
        if st is None:
            if self.graphs and self.graph_set is None:
                self.graph_set = GraphSet(self.ev.ctx.device)
            st = self[name] = WholeGraph(self.ev, fn, self.graphs, self.graph_set,
                                         f"{self.prefix}.{name}")
        return st(cts)

    def tally(self) -> Counter:
        """Every stage's op tally over its calls so far, summed."""
        return sum((st.tally() for st in self.values()), Counter())

    def capture_seconds(self) -> float:
        return sum(st.capture_s for st in self.values())

    def graph_count(self) -> int:
        return sum(st._g is not None for st in self.values())
