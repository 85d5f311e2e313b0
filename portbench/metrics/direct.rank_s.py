"""direct.rank_s: the mean seconds of a window sort's constructRank (stages A-D), a span that ends in a device synchronise."""


def read(run):
    got = run.span_seconds("direct.rank")
    return sum(got) / len(got) if got else None
