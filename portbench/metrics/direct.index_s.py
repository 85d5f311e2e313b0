"""direct.index_s: the mean seconds of a window sort's rotationIndexCheck (stages E-I), a span that ends in a device synchronise."""


def read(run):
    got = run.span_seconds("direct.index")
    return sum(got) / len(got) if got else None
