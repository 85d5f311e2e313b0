"""The program's own spans, for the readers of the per-layer metrics that time its stages.

`fhe_sorting_tpu_torch.core.trace` records a span per stage dispatch while a
`torch.profiler` session records, so the `--trace 1` window's profiled
sorts leave their spans there: name `<sort>.<stage>`, `counts["kind"]`
(eager, capture or replay), `counts["planes"]` (the NTT planes it ran), a
host interval and a device interval in nanoseconds.  Each reader divides
by the run's traced sorts.

Nothing is read (None) where the run's trace holds no device work, as off
the card, where a device interval would be the host's; nor where the
program records no spans (a program without `core/trace.py`).
"""

from __future__ import annotations


def dispatches(run) -> list:
    """The stage dispatch spans of the newest recording window, or []."""
    if not run.trace or not run.traced_sorts:
        return []
    try:
        from fhe_sorting_tpu_torch.core import trace
    except ImportError:
        return []
    return [s for s in trace.spans() if "kind" in s.counts]


def stage_device_s(run, sort: str, stage) -> float | None:
    """Device seconds a sort of the stages `<sort>.<name>` for which
    `stage(name)` holds."""
    got = [s for s in dispatches(run) if s.device is not None
           and s.name.startswith(sort + ".") and stage(s.name[len(sort) + 1:])]
    if not got:
        return None
    return sum(e - b for b, e in (s.device for s in got)) / 1e9 / run.traced_sorts
