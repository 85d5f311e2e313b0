"""hybrid.ind_s: device seconds a traced sort spends in the placement's sign indicator over the tile pairs, the stages `Hsub<b>`, `HB<i>` and `Hcomb`: the program's stage dispatch spans `hybrid.<stage>`."""

from portbench.metrics._program_spans import stage_device_s


def read(run):
    return stage_device_s(run, "hybrid", lambda name: name == "Hcomb"
                          or name.startswith(("Hsub", "HB")))
