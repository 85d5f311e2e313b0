"""One run of one cell: set-up, the measured window, the check against the reference, the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in `BENCHMARK.json`:

  configuration   the file the configs entry names (`configs/<name>.json`):
                  `builder` names `builders/<builder>.py`, `params` the
                  chain (the program's `CkksParams` fields that
                  `program.PARAM_KEYS` lists, `first_mod_bits` among them),
                  `limits` the numbers `correct` is held to
  builder         `rotation_steps(config, ring_n)` and `Sort(ev, config)`;
                  `CONJUGATION_KEY = True` where its sort conjugates (a
                  refresh's CoeffsToSlots), so that the key set holds the
                  conjugation key too
  traffic mix     `traffic/<name>.json`, read by `traffic.py`
  metric          `metrics/<name>.py`, whose `read(run)` returns the value
                  or None where it finds nothing to read

A run (`run_cell`):

  1. set-up, timed as `setup_s` from the process's start: the program's
     context, its keys from the secret the benchmark draws from the seed,
     the pool of inputs encrypted, `warmup_sorts` sorts (the first captures
     the stages; the kernels build at their first use);
  2. the window: sorts back to back through the pool, each ending in a
     device synchronise, started while fewer than `--seconds` have passed;
     the one in flight at the deadline completes and counts.  With
     `--trace 1` the first `traced_sorts` are profiled and the builder's
     spans synchronise at their ends; the window's `--seconds` then start
     after the profiler has stopped, so the spans read unprofiled sorts;
  3. the peak device memory is read, the outputs are copied to the host and
     the program's state is freed;
  4. the plain reference (`reference/ckks.py`) decrypts every output with
     the benchmark's own secret and chain, and each is compared with
     `np.sort` of its input.

The result line has `correct`, `attempted` (sorts in the window), `failed`
(sorts whose output misses the limit), `metrics`, `device`, with `--trace 1`
`breakdown`, and last `checks`: each number compared with its limit.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import math
import os
import time
from contextlib import contextmanager

import numpy as np

from . import program, sol
from . import trace as tracing
from . import traffic as gen
from .reference.ckks import Decryptor, logqp_bits

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)

# modules the process that prints a result may not hold, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "fhe_sorting_tpu")


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, workload: str, root: str = ROOT):
    """(cell, configuration, traffic) of the cell named `workload`."""
    cell = _named(bench["workloads"], workload, "workload")
    entry = _named(bench["configs"], cell["config"], "configuration")
    config = _json(os.path.join(root, entry["file"]))
    mix = _json(os.path.join(root, "portbench", "traffic", f"{cell['traffic']}.json"))
    gen.check(mix)
    return cell, config, mix


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of the cell reports: the end-to-end ones, or with a
    trace the per-layer ones, each where its `workloads` (if any) name the
    cell."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def reader(name: str, root: str = ROOT):
    return _module(os.path.join(root, "portbench", "metrics", f"{name}.py"),
                   f"portbench_metric_{name.replace('.', '_')}")


def builder(name: str, root: str = ROOT):
    return _module(os.path.join(root, "portbench", "builders", f"{name}.py"),
                   f"portbench_builder_{name}")


def forbidden_modules(modules) -> list:
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


class Run:
    """What one run recorded, for the metric readers."""

    def __init__(self, config: dict):
        self.config, self.params = config, config["params"]
        self.spans = []            # (name, sort index or None, start, end) on the host clock
        self.counters = {}
        self.setup_s = None
        self.window = None         # {"seconds": first start to last end, "sorts": n}
        self.errors = []           # per timed sort: max |decrypted - np.sort(input)|
        self.peak_bytes = None
        self.trace = {}            # trace.reduce's numbers
        self.tally = {}            # op tally of the traced sorts
        self.traced_sorts = 0

    def span_seconds(self, name: str) -> list:
        """Durations of the spans `name` in the window, leaving out the
        profiled sorts where later ones exist."""
        got = [(i, e - s) for n, i, s, e in self.spans if n == name and i is not None]
        late = [d for i, d in got if i >= self.traced_sorts]
        return late or [d for _, d in got]

    def setup_span(self, name: str):
        got = [e - s for n, i, s, e in self.spans if n == name and i is None]
        return sum(got) if got else None


@contextmanager
def _no_span(name):
    yield


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", root: str = ROOT, params_over: dict | None = None,
             fault=None, log=print):
    """One run; returns (result dict, check lines).  `params_over` replaces
    some of the configuration's `params` (the control's lower precision);
    `fault(sort, ev, last)`, where given, returns the callable the window
    sorts with in place of the sort, `last` being the warm-up's last output
    (the tests' broken timed paths)."""
    import torch

    bench = load_benchmark(root)
    cell, config, mix = resolve(bench, workload, root)
    if params_over:
        config = dict(config, params={**config["params"], **params_over})
    params = config["params"]
    run = Run(config)
    dev = torch.device("cuda:0" if device == "cuda" else device)
    on_card = dev.type == "cuda"
    build = builder(config["builder"], root)
    prof = tracing.Profiler() if trace else None
    sort_index = [None]

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    @contextmanager
    def setup(name):
        t0 = time.perf_counter()
        yield
        sync()
        run.spans.append((name, None, t0, time.perf_counter()))

    @contextmanager
    def span(name):
        """A span inside a sort: recorded, with a synchronise at its end,
        only in a traced run."""
        if not trace:
            yield
            return
        with prof.annotate(name):
            t0 = time.perf_counter()
            yield
            sync()
        run.spans.append((name, sort_index[0], t0, time.perf_counter()))

    # 1. set-up
    with setup("context"):
        ctx = program.context(params, dev)
    s = gen.secret(params["ring_n"], seed)
    with setup("keygen"):
        keys = program.keys(ctx, s, gen.rng(seed, gen.KEYS),
                            build.rotation_steps(config, params["ring_n"]),
                            conjugation_key=getattr(build, "CONJUGATION_KEY", False))
    from fhe_sorting_tpu_torch.core.evaluator import Evaluator

    ev = Evaluator(ctx, keys)
    srt = build.Sort(ev, config)
    vecs = gen.vectors(mix, config["n"], seed)
    with setup("encrypt"):
        cts = [program.encrypt(keys, v, srt.slots, es)
               for v, es in zip(vecs, gen.encryption_seeds(mix, seed))]
    with setup("warmup"):
        for i in range(mix["warmup_sorts"]):
            last = srt(cts[i % len(cts)], _no_span)
    run.counters["capture_s"] = srt.stages.capture_seconds()
    run.setup_s = time.perf_counter() - t_start
    log(f"# set-up {run.setup_s:.3f}s: " + ", ".join(
        f"{n} {e - s_:.3f}s" for n, i, s_, e in run.spans if i is None))

    # 2. the window
    timed = srt if fault is None else fault(srt, ev, last)
    del last
    outs, ends, before = [], [], None
    t0 = t_go = time.perf_counter()
    i = 0
    while i < (mix["traced_sorts"] if trace else 1) or time.perf_counter() - t_go < seconds:
        if trace and i == 0:
            before = srt.stages.tally()
            prof.start()
        sort_index[0] = i
        with span("sort"):
            out = timed(cts[i % len(cts)], span)
        sync()
        ends.append(time.perf_counter())
        outs.append(out)
        i += 1
        if trace and i == mix["traced_sorts"]:
            prof.stop()
            run.tally = dict(srt.stages.tally() - before)
            run.traced_sorts = i
            t_go = time.perf_counter()     # the profiler's flush takes no time from the sorts after it
    run.window = {"seconds": ends[-1] - t0, "sorts": len(outs)}
    each = np.diff([t0] + ends)
    log(f"# window: {len(outs)} sorts in {run.window['seconds']:.3f}s; one sort "
        f"{each.min():.4f}s to {each.max():.4f}s, median {float(np.median(each)):.4f}s")

    # 3. peak, outputs to the host, the program's state freed
    if on_card:
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
    got = [(o.data.cpu().numpy(), o.level, o.sdeg, o.slots) for o in outs]
    q_program, all_program = list(ctx.q_primes), list(ctx.all_primes)
    del outs, out, cts, timed, srt, ev, keys, ctx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if trace:
        run.trace = tracing.reduce(prof.prof, sol.NTT_KERNELS)

    # 4. the reference
    ref = Decryptor(params, s)
    judged = {}      # (output's digest, pool index) -> error: equal outputs decrypt alike
    for k, (data, level, sdeg, slots) in enumerate(got):
        key = (hashlib.sha1(data.tobytes() + repr((level, sdeg, slots)).encode()).digest(),
               k % len(vecs))
        if key not in judged:
            try:
                vals = ref.decrypt(data, level, sdeg, slots)[: config["n"]]
                err = float(np.abs(vals - np.sort(vecs[key[1]])).max())
            except (ValueError, IndexError, OverflowError):
                err = math.inf
            judged[key] = err if math.isfinite(err) else math.inf
        run.errors.append(judged[key])
    log(f"# outputs: {len(got)} judged, {len(judged)} decrypted, against {len(vecs)} answers that "
        f"differ by {gen.answer_gap(mix, config['n']):.3e} or more; worst error "
        f"{max(run.errors):.6e}")
    limits = config["limits"]
    checks = {
        "max_abs_err": (max(run.errors), limits["max_abs_err"]),
        "chain_primes_off": (sum(a != b for a, b in zip(ref.q, q_program))
                             + abs(len(ref.q) - len(q_program)), 0),
        "logqp_bits": (logqp_bits(all_program), limits["logqp_bits"]),
    }
    failed = sum(not e <= limits["max_abs_err"] for e in run.errors)
    correct = bool(run.errors) and failed == 0 and all(v <= lim for v, lim in checks.values())

    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        v = reader(m["name"], root).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    devinfo = {"platform": "gpu" if on_card else dev.type,
               "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
               "count": cell["chips"], "memory_peak_bytes": run.peak_bytes}
    result = {"correct": correct, "attempted": len(got), "failed": failed,
              "metrics": metrics, "device": devinfo}
    if trace and run.trace:
        devinfo["busy_s"] = run.trace["busy_s"]
        devinfo["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    lines = [f"check {k}: {v!r} (limit {lim!r})" for k, (v, lim) in checks.items()]
    return result, lines
