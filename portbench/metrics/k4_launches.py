"""k4_launches: the launches of K4, the key switch's RNS base extension (`core/rns_bconv.py`), in a traced sort, summed over the program's stage dispatch spans (a replay counts the launches its graph captured); nothing where the program counts none."""

from portbench.metrics._program_spans import dispatches


def read(run):
    launched = sum(s.counts.get("k4", 0) for s in dispatches(run))
    return launched / run.traced_sorts if launched else None
