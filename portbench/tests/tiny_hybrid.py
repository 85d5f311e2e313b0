"""A temporary copy of the benchmark with a test-only hybrid cell at a tiny ring, for the CPU tests.

`make(tmp)` makes `tiny.make`'s copy and adds to it, as new files and new
entries only, the configuration `hybrid_tiny` (the staged hybrid DirectSort
of 8 values over two 4-wide tiles at ring 256, eager: the code path of
`direct_hybrid_n512`'s 512 values over two 256-wide tiles, at its metered
depth and with its own limit, which the tiny sign iterations' error of
about 8e-5 sets) and the cell
`hybrid_tiny.serial`, which every per-layer metric that lists
`hybrid512.serial` also lists.
"""

from __future__ import annotations

import json
import os

from portbench.tests import tiny

CELL = "hybrid_tiny.serial"


def make(tmp) -> str:
    root = tiny.make(tmp)
    with open(os.path.join(root, "portbench", "configs", "direct_hybrid_n512.json")) as f:
        cfg = json.load(f)
    cfg.update(name="hybrid_tiny", n=8, tile=4, sign=[3, 3, 2], indicator_dg=2, graphs=None)
    cfg["params"].update(ring_n=256, mult_depth=33)
    cfg["limits"].update(max_abs_err=1e-3)
    tiny._dump(os.path.join(root, "portbench", "configs", "hybrid_tiny.json"), cfg)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "hybrid_tiny", "source": cfg["source"],
                             "file": "portbench/configs/hybrid_tiny.json",
                             "reduced": ["ring_n", "n", "tile"], "why": "test only"})
    bench["workloads"].append({"name": CELL, "config": "hybrid_tiny", "traffic": "tiny.pool2",
                               "chips": 1, "why": "test only"})
    for m in bench["per_layer"]:
        if "hybrid512.serial" in m.get("workloads", []):
            m["workloads"].append(CELL)
    tiny._dump(os.path.join(root, "BENCHMARK.json"), bench)
    return root
