"""The hybrid cell `hybrid512.serial`: its entries resolve, its key set is the program's one rule, and a tiny copy of it runs through the harness on the CPU, correct, and not correct under each broken timed path."""

import json
import os
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests import test_portbench_faults as faults
from portbench.tests import tiny_hybrid

CELL = "hybrid512.serial"
HYBRID = {"hybrid.rank_s", "hybrid.place_s", "hybrid.ind_s", "hybrid.fold_s", "hybrid.captures"}
# the per-layer metrics the cell shares with the other cells
SHARED = {"k2_launches", "k3_launches", "k4_launches", "ntt_planes", "ntt_device_pct",
          "device_idle_pct", "dispatch_host_us", "keygen_s", "capture_s"}
METRICS = HYBRID | SHARED

torch.set_num_threads(2)


def test_the_cell_its_configuration_and_metrics_resolve():
    b = harness.load_benchmark()
    cell, config, mix = harness.resolve(b, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("direct_hybrid_n512",
                                                                "serial.pool2", 1)
    entry = [c for c in b["configs"] if c["name"] == "direct_hybrid_n512"][0]
    assert entry["reduced"] == [] and entry["file"] == "portbench/configs/direct_hybrid_n512.json"
    assert (config["builder"], config["n"], config["tile"], config["sign"],
            config["indicator_dg"]) == ("hybrid_staged", 512, 256, [3, 5, 2], 5)
    assert config["params"]["ntt_impl"] == "auto" and config["limits"]["logqp_bits"] == 3524
    assert {m["name"] for m in harness.cell_metrics(b, CELL, True)} == METRICS
    assert {m["name"] for m in harness.cell_metrics(b, CELL, False)} == {
        "sort_s", "precision_bits", "peak_mem_gib", "setup_s"}
    for name in METRICS:
        m = [x for x in b["per_layer"] if x["name"] == name][0]
        if name in HYBRID:
            assert m["workloads"] == [CELL] and m["moves"] == "sort_s"
        else:
            assert m["workloads"] == ["direct128.serial", "mehp24_512.serial", CELL]
        assert harness.reader(name).read(harness.Run(config)) is None
    # no other cell reads a hybrid metric
    for other in ("direct128.serial", "mehp24_512.serial"):
        got = {m["name"] for m in harness.cell_metrics(b, other, True)}
        assert not got & HYBRID and SHARED <= got


def test_the_key_set_is_the_programs_one_rule():
    """16 steps at N=512, ring 2^17: constructRank's scan keys and the
    placement's basis."""
    from fhe_sorting_tpu_torch.parallel.direct_staged import scan_rotation_indices
    from fhe_sorting_tpu_torch.parallel.hybrid_staged import hybrid_staged_keys

    _, config, _ = harness.resolve(harness.load_benchmark(), CELL)
    steps = harness.builder(config["builder"]).rotation_steps(config, 1 << 17)
    assert len(steps) == 16
    assert set(steps) == scan_rotation_indices(512, 1 << 17) | hybrid_staged_keys(512, 1 << 17)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_hybrid.make(tmp_path_factory.mktemp("portbench"))


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_hybrid_cell_is_correct(root, trace):
    res, lines = harness.run_cell(tiny_hybrid.CELL, 2**31 + 4321, 0.05, trace,
                                  time.perf_counter(), device="cpu", root=root,
                                  log=lambda m: None)
    line = json.loads(json.dumps(res))
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["checks"]["chain_primes_off"]["value"] == 0
    got = set(line["metrics"])
    if trace:
        # no device here: the device intervals and dispatch kinds are not read
        assert got == {"hybrid.rank_s", "hybrid.place_s", "keygen_s"}
    else:
        assert got == {"sort_s", "precision_bits", "setup_s"}


def half_of_the_answers_left_out(srt, ev, last):
    """Half of the n answers dropped (multiplied by 0): the hybrid's output
    holds its answers in the first n of tile x tile slots."""
    def sort(ct, span):
        out = srt(ct, span)
        mask = np.zeros(out.slots)
        mask[: srt.srt.N // 2] = 1.0
        return ev.mult(out, ev.make_plaintext(mask, out.level + (out.sdeg == 2), 1,
                                              slots=out.slots))
    return sort


@pytest.mark.parametrize("fault", [faults.unchanged, half_of_the_answers_left_out,
                                   faults.altered, faults.stale], ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(root, fault):
    res, _ = harness.run_cell(tiny_hybrid.CELL, 78, 0.05, False, time.perf_counter(),
                              device="cpu", root=root, fault=fault, log=lambda m: None)
    assert res["correct"] is False
    assert res["failed"] == res["attempted"] >= 1
    assert res["checks"]["max_abs_err"]["value"] > res["checks"]["max_abs_err"]["limit"]


def test_the_tiny_cell_is_new_entries_only(root):
    """The copy keeps every entry of the benchmark as it is and adds the
    tiny cell beside them."""
    mine, theirs = harness.load_benchmark(), harness.load_benchmark(root)
    names = {w["name"] for w in theirs["workloads"]}
    assert {w["name"] for w in mine["workloads"]} | {tiny_hybrid.CELL} <= names
    assert os.path.exists(os.path.join(root, "portbench", "configs", "hybrid_tiny.json"))
