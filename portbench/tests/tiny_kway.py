"""A temporary copy of the benchmark with a test-only bootstrapped cell at a tiny ring, for the CPU tests.

`make(tmp)` makes `tiny.make`'s copy and adds to it, as new files and new
entries only: the builder `kway_tiny` (`kway_builder.py`: the k-way
network with real refreshes, asking for the conjugation key), the
configuration `kway_tiny` (k=2, N=4 at ring 256 on the k-way chain of
`utils/kway_run.build`: depth 42, scale 2^56 from prime pairs, a 30-bit
first modulus, dnum 3, and its uniform-secret refresh: K 512, degree 270,
four double-angle steps, two arcsine terms, level budget (3, 3)), the
traffic mix `tiny.wide2` (two vectors whose answers lie 0.1 apart at N=4)
and the cell `kway_tiny.serial`.
"""

from __future__ import annotations

import json
import os
import shutil

from portbench.tests import tiny

CELL = "kway_tiny.serial"
HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = {
    "name": "kway_tiny",
    "source": "Hong, Kim, Cheon et al., Efficient Sorting of Homomorphic Encrypted Data with "
              "k-way Sorting Network, IEEE TIFS 2021; test only",
    "builder": "kway_tiny",
    "n": 4,
    "k": 2,
    "sign": [3, 2, 2],
    "refresh": {"K": 512.0, "sin_degree": 270, "double_angle": 4, "asin_terms": 2,
                "level_budget": [3, 3]},
    "params": {"ring_n": 256, "mult_depth": 42, "scale_bits": 56, "comp": 2, "base_limbs": 4,
               "first_mod_bits": 30, "dnum": 3, "ntt_impl": "auto"},
    "limits": {"max_abs_err": 0.01, "logqp_bits": 3524},
}
MIX = {"pool": 2, "warmup_sorts": 1, "traced_sorts": 1,
       "offset_width": 1.0, "offset_edge": 0.4}


def make(tmp) -> str:
    root = tiny.make(tmp)
    pb = os.path.join(root, "portbench")
    shutil.copy(os.path.join(HERE, "kway_builder.py"), os.path.join(pb, "builders", "kway_tiny.py"))
    tiny._dump(os.path.join(pb, "configs", "kway_tiny.json"), CONFIG)
    tiny._dump(os.path.join(pb, "traffic", "tiny.wide2.json"), MIX)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "kway_tiny", "source": CONFIG["source"],
                             "file": "portbench/configs/kway_tiny.json",
                             "reduced": ["ring_n", "n"], "why": "test only"})
    bench["workloads"].append({"name": CELL, "config": "kway_tiny", "traffic": "tiny.wide2",
                               "chips": 1, "why": "test only"})
    tiny._dump(os.path.join(root, "BENCHMARK.json"), bench)
    return root
