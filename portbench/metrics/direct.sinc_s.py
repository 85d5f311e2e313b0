"""direct.sinc_s: device seconds a traced sort spends in rotationIndexCheck's Paterson-Stockmeyer Chebyshev sinc, the stage `FG`: the program's stage dispatch spans `direct.<stage>`."""

from portbench.metrics._program_spans import stage_device_s


def read(run):
    return stage_device_s(run, "direct", lambda name: name == "FG")
