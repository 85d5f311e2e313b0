"""The device trace of a `--trace 1` run: `torch.profiler` over the first sorts of the window.

`Profiler` wraps the profiled sorts in a host annotation, `portbench.window`,
whose extent is the traced window; each span of the harness inside it is an
annotation too (`record_function`), so an idle gap on the device can be
named by what the host was doing.  `reduce` turns the raw events into the
numbers the per-layer readers use:

  window_s      the traced window's length on the host's clock
  busy_s        the union of the device operations' intervals inside it
  op_s          the device operations' summed durations
  ntt_s         the same for the NTT kernels (`sol.NTT_KERNELS`)
  device_ops    [[name, seconds]] of the ten operations that took most
  idle_gaps     [[host span, seconds]] of the ten longest gaps inside the
                window in which no device operation ran
"""

from __future__ import annotations

from collections import Counter
from contextlib import contextmanager

WINDOW = "portbench.window"


class Profiler:
    def __init__(self):
        self.prof = None
        self._window = None

    def start(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self):
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    @contextmanager
    def annotate(self, name: str):
        import torch

        with torch.profiler.record_function(name):
            yield


def _events(prof):
    """(name, is device op, is host annotation, start_ns, end_ns) of every
    event, from the profiler's raw results."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        annot = e.is_user_annotation()
        on_dev = e.device_type() == cuda
        kind = str(e.activity_type()).lower() if hasattr(e, "activity_type") else ""
        if on_dev and ("annotation" in kind or annot):
            continue
        yield e.name(), on_dev, annot and not on_dev, e.start_ns(), e.end_ns()


def _union(spans):
    """Merged intervals of [(start, end)]."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, ntt_kernels) -> dict:
    ops, notes, window = [], [], None
    for name, on_dev, annot, s, e in _events(prof):
        if on_dev:
            ops.append((name, s, e))
        elif annot:
            if name == WINDOW:
                window = (s, e)
            else:
                notes.append((name, s, e))
    if window is None or not ops:
        return {}
    w0, w1 = window
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in ops if e > w0 and s < w1]
    by_name = Counter()
    for n, s, e in inside:
        by_name[n] += (e - s) / 1e9
    busy = _union([(s, e) for _, s, e in inside])
    gaps, cur = [], w0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        gaps.append((cur, w1))

    def doing(t):
        """The innermost host span around t."""
        best = None
        for n, s, e in notes:
            if s <= t <= e and (best is None or e - s < best[2] - best[1]):
                best = (n, s, e)
        return best[0] if best else "between spans"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return dict(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        op_s=sum(by_name.values()),
        ntt_s=sum(v for n, v in by_name.items() if any(k in n for k in ntt_kernels)),
        device_ops=[[n[:160], v] for n, v in by_name.most_common(10)],
        idle_gaps=[[doing((s + e) / 2), (e - s) / 1e9] for s, e in longest],
    )
