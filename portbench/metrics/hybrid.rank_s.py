"""hybrid.rank_s: the mean seconds of a window sort's constructRank (four 128-value batches at N=512), a span that ends in a device synchronise."""


def read(run):
    got = run.span_seconds("hybrid.rank")
    return sum(got) / len(got) if got else None
