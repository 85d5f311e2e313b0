"""dispatch_host_us: mean host microseconds of one stage dispatch in a traced sort (copy-in, graph replay call, clone-out and their Python): the program's dispatch spans."""

from portbench.metrics._program_spans import dispatches


def read(run):
    got = dispatches(run)
    return sum(s.end - s.start for s in got) / 1e3 / len(got) if got else None
