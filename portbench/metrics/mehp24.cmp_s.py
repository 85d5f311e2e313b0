"""mehp24.cmp_s: device seconds a traced sort spends in the sign comparisons, the stage `cmp`: the program's stage dispatch spans `mehp24.<stage>`."""

from portbench.metrics._program_spans import stage_device_s


def read(run):
    return stage_device_s(run, "mehp24", lambda name: name == "cmp")
