"""BENCHMARK.json against the benchmark's contract, and a cell, configuration, traffic mix and metric added as files alone."""

import json
import os
import re

from portbench import harness, traffic
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return harness.load_benchmark()


def test_top_level_keys_command_and_paths():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= len(b["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024
    # 2 + 14 runs a cell at 24 cells, each run_seconds + 60, 180 a cell, 1200 spare
    assert 1 <= b["run_seconds"] <= 51
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    b = _bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for text in [c["source"] for c in b["configs"]] + [x["why"] for x in b["configs"] + b["workloads"]] \
            + [m["layer"] for m in b["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    names = [x["name"] for x in b["configs"]] + [x["name"] for x in b["workloads"]] \
        + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))


def test_metrics_bounds_and_cells():
    b = _bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
    assert {w["config"] for w in b["workloads"]} == {c["name"] for c in b["configs"]}
    for cell in cells:
        assert len(harness.cell_metrics(b, cell, False)) >= 2
        assert harness.cell_metrics(b, cell, True)
        for m in harness.cell_metrics(b, cell, False) + harness.cell_metrics(b, cell, True):
            assert os.path.exists(os.path.join(harness.ROOT, "portbench", "metrics",
                                               f"{m['name']}.py"))
        harness.resolve(b, cell)


def test_the_answers_to_two_requests_lie_far_apart():
    """An answer to another request of the pool, such as a stale output,
    misses every cell's limit by far."""
    b = _bench()
    for cell in b["workloads"]:
        _, config, mix = harness.resolve(b, cell["name"])
        assert mix["pool"] >= 2
        assert traffic.answer_gap(mix, config["n"]) > 10 * config["limits"]["max_abs_err"]


def test_a_new_cell_configuration_traffic_and_metric_are_files_and_entries(tmp_path):
    """Added to a copy by new files and new entries alone, each is found by
    its name: no file of the harness is edited."""
    root = tiny.make(tmp_path)
    with open(os.path.join(root, "portbench", "metrics", "sorts_in_window.py"), "w") as f:
        f.write('"""sorts_in_window: how many sorts the window held."""\n\n\n'
                'def read(run):\n    return run.window["sorts"] if run.window else None\n')
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "sorts_in_window", "unit": "sorts", "better": "higher",
                               "source": "program_counter", "layer": "sort: harness window",
                               "moves": "sort_s", "workloads": [tiny.CELL]})
    with open(path, "w") as f:
        json.dump(bench, f)
    b = harness.load_benchmark(root)
    cell, config, mix = harness.resolve(b, tiny.CELL, root)
    assert (cell["config"], config["n"], mix["pool"]) == ("direct_tiny", 4, 2)
    names = [m["name"] for m in harness.cell_metrics(b, tiny.CELL, True)]
    assert "sorts_in_window" in names and "direct.rank_s" in names
    assert "sorts_in_window" not in [m["name"] for m in harness.cell_metrics(b, "direct128.serial", True)]
    run = harness.Run(config)
    run.window = {"seconds": 2.0, "sorts": 5}
    assert harness.reader("sorts_in_window", root).read(run) == 5
    assert harness.builder(config["builder"], root).Sort is not None
    # a reader that finds nothing returns nothing
    assert harness.reader("ntt_roofline_pct", root).read(run) is None
    assert harness.reader("device_idle_pct", root).read(run) is None
