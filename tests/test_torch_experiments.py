"""The port's experiment, probe and rotation harnesses on the CPU.

`utils/experiments.py` against the JAX package's `benchmarks/run_experiments.py`
and `benchmarks/aggregate.py`: the same total_results.txt from the same
summaries, the same input vectors, the same configuration and row schema
for a DirectSort size at the smallest ring the JAX harness's direct
configuration accepts (8: ring 4 leaves no slot batch), with max error below
0.01.  One cheap call each of `probe_direct`, `rotation_bench` and
`auto_microbench` on the CPU."""

import json
import shutil
import sys

import numpy as np
import pytest
import torch

from benchmarks import aggregate as j_aggregate
from fhe_sorting_tpu.ops.sign import CompositeSignConfig as JCompositeSignConfig
from fhe_sorting_tpu.ops.sign import SignConfig as JSignConfig
from fhe_sorting_tpu.utils.depth_meter import measure_direct_sort_depth as j_depth
from fhe_sorting_tpu.utils.params_registry import direct_sort_sign_cfg as j_sign_cfg
from fhe_sorting_tpu_torch.utils import auto_microbench, experiments, probe_direct, rotation_bench

from .utils import vector_with_min_diff as j_vector

torch.set_num_threads(2)

# the summary row of benchmarks/run_experiments.py:run_size (:263-270)
ROW_KEYS = {"N", "trials", "mean_time_s", "warmup_s", "max_err_log2", "avg_err_log2", "config"}
SMALLEST_RING = 8


@pytest.mark.parametrize("n,seed", [(4, 0), (8, 1), (16, 2), (128, 5)])
def test_vector_with_min_diff_matches_tests_utils(n, seed):
    np.testing.assert_array_equal(experiments.vector_with_min_diff(n, seed=seed), j_vector(n, seed=seed))


@pytest.mark.parametrize("algo", [None, "kway"])
def test_aggregate_matches_jax(tmp_path, monkeypatch, algo):
    """Both write the same total_results.txt from the same summary files."""
    rows = [{"N": n, "trials": 3, "mean_time_s": 0.5 * n, "warmup_s": 1.25 + n,
             "max_err_log2": -20.5 + n, "avg_err_log2": -24.0, "config": {"dg": 3, "df": 2}}
            for n in (16, 4, 8)]
    dirs = [tmp_path / "port" / "direct", tmp_path / "jax" / "direct"]
    for d in dirs:
        d.mkdir(parents=True)
        for r in rows:
            (d / f"N{r['N']}_summary.txt").write_text(json.dumps(r, indent=1))
    experiments.aggregate(str(dirs[0]), algo)
    monkeypatch.setattr(sys, "argv", ["aggregate", str(dirs[1])] + (["--algo", algo] if algo else []))
    j_aggregate.main()
    got, want = ((d / "total_results.txt").read_bytes() for d in dirs)
    assert got == want
    assert [r["N"] for r in json.loads(got)["results"]] == [4, 8, 16]


@pytest.mark.parametrize("subprocess_per_n", [False, True])
def test_direct_size_row(tmp_path, subprocess_per_n):
    """`main` runs one DirectSort size (in this process or a fresh one) into
    `--out`: a row with the JAX schema's keys, the JAX harness's configuration,
    max error below 0.01; and `aggregate` rebuilds the same total."""
    out = tmp_path / "direct"
    argv = ["--algo", "direct", "--sizes", "4", "--trials", "1", "--ring", str(SMALLEST_RING),
            "--device", "cpu", "--out", str(out)] + (["--subprocess-per-N"] if subprocess_per_n else [])
    (row,) = experiments.main(argv)
    assert set(row) == ROW_KEYS
    assert row["N"] == 4 and row["trials"] == 1 and row["config"]["device"] == "cpu"
    assert 2.0 ** row["max_err_log2"] < 0.01
    _, dg, df = j_sign_cfg(4)
    depth = j_depth(4, SMALLEST_RING, JSignConfig(JCompositeSignConfig(3, dg, df)))["mult_depth"]
    assert {k: row["config"][k] for k in ("dg", "df", "mult_depth")} == {
        "dg": dg, "df": df, "mult_depth": depth}
    assert json.loads((out / "N4_summary.txt").read_text()) == row
    total = json.loads((out / "total_results.txt").read_text())
    assert total == {"algo": "direct", "results": [row]}
    shutil.copy(out / "total_results.txt", tmp_path / "by_main.txt")
    assert experiments.main(["--aggregate", str(out)]) == total
    assert (out / "total_results.txt").read_bytes() == (tmp_path / "by_main.txt").read_bytes()


def test_unknown_algo_raises():
    with pytest.raises(ValueError):
        experiments.build_sorter("quick", 4, SMALLEST_RING, None, None, None, 2, "cpu")


def test_probe_direct_cpu(capsys):
    res = probe_direct.main(["--n", "4", "--ring", "16", "--device", "cpu"])
    assert res["device"] == "cpu" and res["n"] == 4
    assert res["rank_err"] < 0.01 and res["sort_err"] < 0.01
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res


def test_rotation_bench_cpu(capsys, monkeypatch):
    monkeypatch.delenv("FHE_AFFINE_AUTO", raising=False)
    res = rotation_bench.main(["--ring", "256", "--depth", "2", "--chains", "1", "3",
                               "--reps", "1", "--device", "cpu"])
    assert res["metric"] == "rotate_chain_ms" and res["ring"] == 256 and res["device"] == "cpu"
    assert set(res["results"]) == {"1", "3"} and not res["affine"]
    assert all(v["plain_ms"] > 0 and v["hoisted_ms"] > 0 for v in res["results"].values())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res


def test_auto_microbench_cpu():
    """Held equal to the gather for every element it checks; on the CPU no
    share of the card's bound is claimed."""
    res = auto_microbench.main(["--ring", "256", "--depth", "2", "--limbs", "3", "--reps", "1",
                                "--device", "cpu"])
    assert res["shape"] == [2, 3, 256] and res["device"] == "cpu"
    assert res["checked"] == ["rotate 1", "rotate -1", "rotate 64", "conjugate"]
    assert res["affine_share_of_bound"] is None
    assert res["gather_bound_ms"] == 2 * 2 * 3 * 256 * 8 / 3.35e12 * 1e3
