"""The port's flagship benchmark (`fhe_sorting_tpu_torch/utils/bench.py`)
against the JAX package's `bench.py`, on the CPU.

At N=8 on ring 512 (the tests/test_direct_staged.py shape) with one timed
trial: the worker's result has exactly `bench.py`'s keys, its sort error is
below 0.01 (the reference's accuracy contract), its logQP is the JAX
`Context`'s for the same parameters, ring 512 has no 128-bit budget, and
`vs_baseline` is the reference's N=8 mean over the measured seconds.  The
orchestrator streams one line per N and then the combined line, and a
worker that fails gives an error line and exit code 1.  `slow`: the JAX
worker at the same arguments gives the same metric, chain and security
fields, with both errors below 0.01."""

import argparse
import json
import math

import pytest
import torch

from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.ops.sign import CompositeSignConfig as JCompositeSignConfig
from fhe_sorting_tpu.ops.sign import SignConfig as JSignConfig
from fhe_sorting_tpu.utils.depth_meter import measure_direct_sort_depth as j_depth
from fhe_sorting_tpu.utils.params_registry import direct_sort_sign_cfg as j_sign_cfg
from fhe_sorting_tpu_torch.utils import bench

torch.set_num_threads(2)

# the result keys of bench.py's worker (bench.py:242-260)
RESULT_KEYS = {"metric", "unit", "value", "vs_baseline", "max_error", "err_method", "phase_s",
               "phase_pct_of_sol", "logqp_bits", "logqp_128bit_budget", "security_128bit",
               "pct_of_sol", "sol_bound_s", "baseline_ref_s"}
N, RING = 8, 512
ARGV = ["--n", str(N), "--ring", str(RING), "--trials", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def result():
    return bench.worker(bench._parser().parse_args(ARGV + ["--worker"]))


def test_worker_result_keys_and_values(result):
    assert set(result) == RESULT_KEYS
    assert result["metric"] == f"directsort_n{N}_ring{RING}_wall_clock" and result["unit"] == "s"
    assert result["max_error"] < 0.01 and result["err_method"] == "decrypt"
    assert result["value"] > 0 and result["baseline_ref_s"] == 249.99
    assert result["vs_baseline"] == round(249.99 / result["value"], 2)
    assert set(result["phase_s"]) == set(result["phase_pct_of_sol"]) == {
        "constructRank", "rotationIndexCheck"}
    # a CPU time is no share of the card's speed of light
    assert result["pct_of_sol"] is None and set(result["phase_pct_of_sol"].values()) == {None}
    assert result["sol_bound_s"] >= 0


def test_worker_chain_matches_jax_context(result):
    """The same chain as the JAX package builds for the same parameters:
    logQP to the printed decimal, and no 128-bit budget at ring 512."""
    cfg = JSignConfig(JCompositeSignConfig(*j_sign_cfg(N)))
    depth = j_depth(N, RING, cfg)["mult_depth"]
    jctx = JContext(JParams(ring_n=RING, mult_depth=depth, scale_bits=56, comp=2,
                            base_limbs=4, dnum=3))
    assert result["logqp_bits"] == round(sum(math.log2(p) for p in jctx.all_primes), 1)
    assert result["logqp_128bit_budget"] is None and result["security_128bit"] is False


def test_worker_cmd_forwards_every_override():
    args = bench._parser().parse_args(["--trials", "3", "--depth", "40", "--dg", "5",
                                       "--device", "cpu"])
    cmd = bench._worker_cmd(args, 128)
    assert cmd[cmd.index("--trials") + 1] == "3" and cmd[cmd.index("--depth") + 1] == "40"
    assert cmd[cmd.index("--dg") + 1] == "5" and cmd[cmd.index("--device") + 1] == "cpu"
    assert "--cn" not in cmd and "--worker" in cmd
    # N >= 512: one timed trial, as in the reference
    big = bench._worker_cmd(args, 1024)
    assert big[big.index("--trials") + 1] == "1" and big[big.index("--n") + 1] == "1024"


def _lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_main_streams_each_n_then_the_combined_line(capfd, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    assert bench.main(ARGV) == 0
    out, err = capfd.readouterr()
    first, combined = _lines(out)
    assert set(first) == RESULT_KEYS | {"baseline_src"}
    assert first["baseline_src"] == bench.BASELINE_SRC and first["max_error"] < 0.01
    assert combined == first
    k1, k2 = map(int, bench.LAUNCH_LINE.search(err).groups())
    assert k1 == k2 == 0               # the CPU runs the kernels' plain versions


def test_main_failed_worker_gives_an_error_line_and_exit_1(capfd, monkeypatch):
    """A chain too short for the sort: the worker raises, and its N still
    gets its line."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    assert bench.main(ARGV + ["--depth", "2"]) == 1
    out, err = capfd.readouterr()
    first, combined = _lines(out)
    assert "error" in first and first["baseline_src"] == bench.BASELINE_SRC
    assert "error" in combined
    assert "depth exhausted" in err


@pytest.mark.slow
def test_worker_matches_jax_bench(result):
    import bench as j_bench

    jres = j_bench.worker(argparse.Namespace(n=N, ring=RING, trials=1, depth=None, cn=None,
                                             dg=None, df=None, comp=2, dnum=3))
    for key in ("metric", "logqp_bits", "logqp_128bit_budget", "security_128bit",
                "baseline_ref_s"):
        assert result[key] == jres[key], key
    assert jres["max_error"] < 0.01 and result["max_error"] < 0.01
