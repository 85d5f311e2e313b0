"""The port's bootstrap harness (`fhe_sorting_tpu_torch/utils/run_bootstrap.py`)
against the JAX package's `benchmarks/run_bootstrap.py`, on the CPU.

At ring 256 (the ring of tests/test_torch_bootstrap.py), its default
sparse secret, level budget 3 and depth 30: the row has the JAX script's
keys with `bootstrap_s_cpu`, a max error below 1e-2 (the bound of
tests/test_bootstrap.py:178), and is appended to the `--out` file.  The
EvalMod shape per ring and secret is the JAX script's.  `slow`: the levels,
slots and chain of the row equal the JAX script's at the same arguments."""

import json
import sys

import numpy as np
import pytest
import torch

from fhe_sorting_tpu_torch.utils import run_bootstrap

torch.set_num_threads(2)

# the row keys of benchmarks/run_bootstrap.py (:103-115) on the CPU
ROW_KEYS = {"ring", "level_budget", "slots", "max_err", "mean_err", "levels_consumed",
            "out_level", "setup_s", "bootstrap_s_cpu", "secret", "chain"}
ARGV = ["--ring", "256", "--device", "cpu"]


@pytest.fixture(scope="module")
def row(tmp_path_factory):
    out = tmp_path_factory.mktemp("boot") / "level_budgets.json"
    out.write_text(json.dumps([{"ring": 0}]))
    got = run_bootstrap.main(ARGV + ["--out", str(out)])
    return got, json.loads(out.read_text())


def test_row_keys_error_and_file(row):
    got, rows = row
    assert set(got) == ROW_KEYS
    assert got["max_err"] < 1e-2 and got["slots"] == 128 and got["secret"] == "hamming64"
    assert got["level_budget"] == [3, 3] and 0 < got["levels_consumed"] < 30
    assert rows == [{"ring": 0}, got]


@pytest.mark.parametrize("ring", [4096, 8192, 16384, 32768, 65536, 131072])
@pytest.mark.parametrize("uniform", [False, True])
def test_shape_is_the_jax_scripts(ring, uniform):
    """benchmarks/run_bootstrap.py:70-85, written out."""
    if uniform:
        K = {4096: 128.0, 8192: 128.0, 16384: 256.0, 32768: 256.0, 65536: 512.0}.get(ring, 512.0)
        want = dict(K=K, sin_degree=270, double_angle=int(np.log2(K)) - 5, asin_terms=3)
    else:
        want = dict(K=13.0, sin_degree=64, double_angle=2, asin_terms=3)
    assert run_bootstrap.shape(ring, uniform) == want
    assert run_bootstrap.shape(ring, uniform, 99, 2) == dict(want, sin_degree=99, asin_terms=2)
    assert run_bootstrap.basis(ring) == sorted({1 << i for i in range(ring.bit_length() - 2)})


@pytest.mark.slow
def test_row_matches_jax_script(row, tmp_path, monkeypatch):
    from benchmarks import run_bootstrap as j_run_bootstrap

    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["run_bootstrap", "--ring", "256", "--platform", "cpu",
                                      "--out", str(out)])
    j_run_bootstrap.main()
    (jrow,) = json.loads(out.read_text())
    got, _ = row
    assert set(jrow) == ROW_KEYS
    for key in ("levels_consumed", "out_level", "slots", "chain", "level_budget", "secret"):
        assert got[key] == jrow[key], key
    assert jrow["max_err"] < 1e-2
