"""hybrid.fold_s: device seconds a traced sort spends in the placement's binary-path folds, the stages `Hplace*` and `Hfin`: the program's stage dispatch spans `hybrid.<stage>`."""

from portbench.metrics._program_spans import stage_device_s


def read(run):
    return stage_device_s(run, "hybrid", lambda name: name == "Hfin"
                          or name.startswith("Hplace"))
