"""hybrid.place_s: the mean seconds of a window sort's rotationIndexCheckHybrid (the tile pairs' sign indicator and the binary-path folds), a span that ends in a device synchronise."""


def read(run):
    got = run.span_seconds("hybrid.place")
    return sum(got) / len(got) if got else None
