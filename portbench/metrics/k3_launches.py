"""k3_launches: the launches of K3, the exact division by a dropped modulus (`core/rns_div.py`), in a traced sort, summed over the program's stage dispatch spans (a replay counts the launches its graph captured); nothing where the program counts none."""

from portbench.metrics._program_spans import dispatches


def read(run):
    launched = sum(s.counts.get("k3", 0) for s in dispatches(run))
    return launched / run.traced_sorts if launched else None
