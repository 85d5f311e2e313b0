"""direct.sign_s: device seconds a traced sort spends in constructRank's composite-sign iterations, the stages `Bg<i>` and `Bf<i>`: the program's stage dispatch spans `direct.<stage>`."""

from portbench.metrics._program_spans import stage_device_s


def read(run):
    return stage_device_s(run, "direct", lambda name: name.startswith("B"))
