"""capture_s: the host seconds the program spent capturing the stages' CUDA graphs (`StageTable.capture_seconds()`)."""


def read(run):
    v = run.counters.get("capture_s")
    return v if v else None
