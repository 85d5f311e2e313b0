"""A temporary copy of the benchmark with a test-only cell at a tiny ring, for the CPU tests.

`make(tmp)` copies `BENCHMARK.json` and `portbench/` into `tmp` and adds,
as new files and new entries only, the configuration `direct_tiny` (the
staged DirectSort of 4 values at ring 256, eager), the traffic mix
`tiny.pool2` and the cell `direct_tiny.serial`, which every per-layer
metric that lists cells also lists.
"""

from __future__ import annotations

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "direct_tiny.serial"


def _dump(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make(tmp) -> str:
    root = str(tmp)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "portbench", "configs", "direct_n128.json")) as f:
        cfg = json.load(f)
    cfg.update(name="direct_tiny", n=4, sign=[3, 3, 2], graphs=None)
    cfg["params"].update(ring_n=256, mult_depth=26)
    _dump(os.path.join(root, "portbench", "configs", "direct_tiny.json"), cfg)
    _dump(os.path.join(root, "portbench", "traffic", "tiny.pool2.json"),
          {"pool": 2, "warmup_sorts": 2, "traced_sorts": 1})
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "direct_tiny", "source": cfg["source"],
                             "file": "portbench/configs/direct_tiny.json", "reduced": ["ring_n"],
                             "why": "test only"})
    bench["workloads"].append({"name": CELL, "config": "direct_tiny", "traffic": "tiny.pool2",
                               "chips": 1, "why": "test only"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    return root
