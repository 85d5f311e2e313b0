"""mehp24.fold_s: device seconds a traced sort spends in the rank and placement folds, the stages `acc`, `flip`, `sv`, `sh`, `acc2`, `align` and `place`: the program's stage dispatch spans `mehp24.<stage>`."""

from portbench.metrics._program_spans import stage_device_s

FOLDS = {"acc", "flip", "sv", "sh", "acc2", "align", "place"}


def read(run):
    return stage_device_s(run, "mehp24", lambda name: name in FOLDS)
