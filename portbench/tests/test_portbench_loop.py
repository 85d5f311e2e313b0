"""The harness's loop once on the CPU at a tiny ring (a test-only cell in a temporary copy), and the command's refusals."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import harness
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("portbench"))


@pytest.mark.parametrize("trace", [False, True])
def test_one_run_prints_a_well_formed_line(root, trace):
    res, lines = harness.run_cell(tiny.CELL, 2**31 + 12345, 0.05, trace, time.perf_counter(),
                                  device="cpu", root=root, log=lambda m: None)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["checks"]) == {"max_abs_err", "chain_primes_off", "logqp_bits"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert len(lines) == 3 and all("limit" in s for s in lines)
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    got = set(line["metrics"])
    if trace:
        # no device here: the readers of the trace and of the graphs find nothing
        assert got == {"direct.rank_s", "direct.index_s", "keygen_s"}
    else:
        # no device memory here
        assert got == {"sort_s", "precision_bits", "setup_s"}
        assert line["metrics"]["precision_bits"]["value"] > 18
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]


def test_the_same_seed_gives_the_same_inputs_and_secret():
    from portbench import traffic

    mix = {"pool": 3, "warmup_sorts": 1, "traced_sorts": 1}
    a, b = traffic.vectors(mix, 64, 2**33 + 1), traffic.vectors(mix, 64, 2**33 + 1)
    assert all((x == y).all() for x, y in zip(a, b))
    answers = [np.sort(v) for v in a]
    for i in range(len(answers)):
        for j in range(i):
            assert np.abs(answers[i] - answers[j]).min() >= traffic.answer_gap(mix, 64)
    assert (traffic.secret(256, 7) == traffic.secret(256, 7)).all()
    assert not (traffic.secret(256, 7) == traffic.secret(256, 8)).all()
    for v in a:
        s = sorted(v)
        assert 0 < s[0] and s[-1] < 1 and min(y - x for x, y in zip(s, s[1:])) > 0.99 / 64


# sha256 (first 32 hex digits) of serial.pool2's stacked vectors at N and a
# seed, as the mix drew them before a mix could set its offsets
POOL2 = {(128, 3100000001): "69d8bbcca67c91205a3125d5ada01d01",
         (128, 2**31 + 12345): "a268e70be70c2f5cf448a962517a6ea9",
         (512, 3100000001): "d5ea72ec9a9c5d2b401df338aaecd02b",
         (512, 2**31 + 12345): "4e43f291e53a835e0ac1d6dd193ee1d5"}


@pytest.mark.parametrize("n, seed", sorted(POOL2))
def test_a_mix_without_offsets_draws_what_it_drew_before(n, seed):
    import hashlib

    from portbench import traffic

    with open(os.path.join(harness.ROOT, "portbench", "traffic", "serial.pool2.json")) as f:
        mix = json.load(f)
    assert not set(mix) & set(traffic.OFFSETS)
    got = np.stack(traffic.vectors(mix, n, seed))
    assert hashlib.sha256(got.tobytes()).hexdigest()[:32] == POOL2[n, seed]
    assert traffic.answer_gap(mix, n) == 2 * 0.2 * 0.5 / 2 / n


def test_a_wide_mix_sets_its_answers_far_apart():
    """Offsets over all of (0, 1), 0.4 of each stratum kept free: answers 0.1
    apart at N=4 and a pool of 2, values in (0, 1), 1/N apart, no ties."""
    from portbench import traffic

    mix = {"pool": 2, "warmup_sorts": 1, "traced_sorts": 1,
           "offset_width": 1.0, "offset_edge": 0.4}
    assert traffic.answer_gap(mix, 4) >= 0.1
    for seed in (1, 2**31 + 5, 2**33 + 9):
        vecs = traffic.vectors(mix, 4, seed)
        a, b = (np.sort(v) for v in vecs)
        assert np.abs(a - b).min() >= traffic.answer_gap(mix, 4)
        for v in vecs:
            s = np.sort(v)
            assert 0 < s[0] and s[-1] < 1 and np.allclose(np.diff(s), 0.25)


@pytest.mark.parametrize("over", [{"offset_width": 0.0}, {"offset_width": 1.1},
                                  {"offset_edge": 0.0}, {"offset_edge": 0.5},
                                  {"offset_spread": 0.1}])
def test_offsets_out_of_range_are_refused(over):
    from portbench import traffic

    with pytest.raises(ValueError):
        traffic.check({"pool": 2, "warmup_sorts": 1, "traced_sorts": 1, **over})


def _command(cwd, *extra):
    b = harness.load_benchmark()
    return subprocess.run(b["command"] + ["--workload", "direct128.serial", "--seed", "1",
                                          "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is for a machine without one")
    out = _command(harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_the_command_fails_where_only_the_benchmark_is(tmp_path):
    """A directory with BENCHMARK.json and portbench/ alone holds no program."""
    import shutil

    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "direct128.serial",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""
