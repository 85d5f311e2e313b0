"""ntt_planes: the limb planes K1 and K2 transform in a traced sort, summed over the program's stage dispatch spans (a replay counts the planes its graph captured)."""

from portbench.metrics._program_spans import dispatches


def read(run):
    got = dispatches(run)
    planes = sum(s.counts["planes"] for s in got)
    return planes / run.traced_sorts if planes else None
