"""On the card: each cell's control, the program's lower-precision path, comes out as not correct.

Run on the chip with

    python -m pytest --noconftest -q -m cuda portbench/tests/test_portbench_control.py

at each cell's own size, on three seeds, with a window of 9 seconds, which
sorts both vectors of each cell's pool (about 3 minutes for
`direct128.serial`, 6 for `mehp24_512.serial`).
"""

import pytest

from portbench import control, harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_benchmark()["workloads"]])
def test_the_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    rows = control.readings(cell, [2**31 + 101, 2**31 + 102, 2**31 + 103], 9.0, True,
                            log=lambda m: None)
    assert rows and all(r["correct"] is False for r in rows), rows
