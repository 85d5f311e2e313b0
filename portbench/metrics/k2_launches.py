"""k2_launches: the launches of K2, the butterfly NTT (`core/bf_ntt.py`), in a traced sort, summed over the program's stage dispatch spans (a replay counts the launches its graph captured); nothing where the program counts none, as where the sorts' NTT is K1."""

from portbench.metrics._program_spans import dispatches


def read(run):
    launched = sum(s.counts.get("k2", 0) for s in dispatches(run))
    return launched / run.traced_sorts if launched else None
