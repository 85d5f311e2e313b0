"""The port's multi-process dryrun, `utils.multichip.dryrun_multichip`.

The same three steps as the JAX package's `__graft_entry__.dryrun_multichip`
(tests/test_multichip_dryrun.py), each rank a gloo process on the CPU:
ShardedDirectSort N=16 at ring 64 over num_batch=8, the same sort on a 2D
("batch", "limb") mesh from four ranks, and the MEHP24 triangle.  Two and
four ranks run in tier-1; eight, the JAX test's device count, under `slow`
(eight processes on the CPU the test workers share).  The printed errors
must meet the reference's 0.01 contract."""

import re

import pytest

from fhe_sorting_tpu_torch.utils.multichip import dryrun_multichip


@pytest.mark.parametrize("ranks", [2, 4, pytest.param(8, marks=pytest.mark.slow)])
def test_dryrun_multichip(ranks, capfd):
    dryrun_multichip(ranks, backend="gloo")
    out = capfd.readouterr().out
    assert f"dryrun_multichip({ranks}): sharded sort step OK" in out
    errs = [float(m) for m in re.findall(r"err ([0-9.]+)", out)]
    assert len(errs) >= (3 if ranks >= 4 else 2), out
    assert max(errs) < 0.01, f"sorted error contract violated: {errs}"
    if ranks >= 4:
        assert "on 2D mesh {'batch': %d, 'limb': 2}" % (ranks // 2) in out
