"""The port's sign characterizer against the JAX package's: CompositeSign(3,1,1)
at ring 256 on the JAX package's keys gives the same working precision and
depth consumed (both exact: the sweep's steps are decades and the errors at
the step that stops it are far from the 0.01 threshold), and the CLI prints
the same JSON record."""

import json

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu.utils.sign_characterizer import characterize as j_characterize
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.utils.sign_characterizer import characterize, main

torch.set_num_threads(2)

RING = 256
DEPTH = (1 + 1) * 3 + 4         # the characterizer's default for (3, 1, 1)


@pytest.fixture(scope="module")
def reference():
    return j_characterize(3, 1, 1, ring=RING)


def test_characterize_matches_jax(reference):
    jkeys = JKeys.generate(JContext(JParams(ring_n=RING, mult_depth=DEPTH)), seed=0)
    ctx = Context(CkksParams(ring_n=RING, mult_depth=DEPTH), device="cpu")
    keys = Keys.from_numpy(ctx, jkeys.s_coeffs, jkeys.s_eval, jkeys.pk[0], jkeys.pk[1],
                           np.asarray(jkeys.relin.kb), np.asarray(jkeys.relin.ka))
    got = characterize(3, 1, 1, keys=keys)
    assert reference["working_precision"] is not None
    for key in ("config", "working_precision", "depth_consumed"):
        assert got[key] == reference[key], key
    assert got["time_s"] > 0


def test_characterizer_cli_prints_the_jax_record(reference, capsys):
    main(["--configs", "3,1,1", "--ring", str(RING), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out) == 1 and out[0].keys() == reference.keys()
    assert {k: out[0][k] for k in ("config", "working_precision", "depth_consumed")} == \
        {k: reference[k] for k in ("config", "working_precision", "depth_consumed")}


def test_characterize_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        characterize(3, 1, 1, ring=RING)
