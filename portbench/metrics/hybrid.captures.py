"""hybrid.captures: the stage dispatches of a traced sort that captured a CUDA graph instead of replaying one (kind "capture"): 0 where every graph survives from the warm-up, one a stage where a sort captures anew; nothing where the program records no dispatch spans."""

from portbench.metrics._program_spans import dispatches


def read(run):
    got = dispatches(run)
    if not got:
        return None
    return sum(s.counts["kind"] == "capture" for s in got) / run.traced_sorts
