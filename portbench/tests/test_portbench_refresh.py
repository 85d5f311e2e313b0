"""Room for a bootstrapped sort, added as new files and entries alone: a configuration that states its chain's first modulus, a builder that asks for the conjugation key, and a traffic mix whose answers lie far apart, run through the harness on the CPU at ring 256."""

import json
import os
import time

import numpy as np
import torch

from portbench import harness, traffic
from portbench.reference import ckks
from portbench.tests import tiny, tiny_kway

torch.set_num_threads(2)

Q0_CELL = "direct_tiny_q0.serial"


def _with_first_modulus(tmp) -> str:
    """`tiny.make`'s copy, with a copy of its configuration that sets
    `first_mod_bits` 30 and a cell on it."""
    root = tiny.make(tmp)
    path = os.path.join(root, "portbench", "configs", "direct_tiny.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["name"] = "direct_tiny_q0"
    cfg["params"]["first_mod_bits"] = 30
    tiny._dump(os.path.join(root, "portbench", "configs", "direct_tiny_q0.json"), cfg)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "direct_tiny_q0", "source": cfg["source"],
                             "file": "portbench/configs/direct_tiny_q0.json",
                             "reduced": ["ring_n"], "why": "test only"})
    bench["workloads"].append({"name": Q0_CELL, "config": "direct_tiny_q0",
                               "traffic": "tiny.pool2", "chips": 1, "why": "test only"})
    tiny._dump(os.path.join(root, "BENCHMARK.json"), bench)
    return root


def test_a_configuration_with_a_first_modulus_is_judged_on_its_chain(tmp_path, monkeypatch):
    """`first_mod_bits` reaches the program's chain and the reference's:
    correct, no prime off.  The same outputs judged on the chain without
    the key decrypt to noise."""
    root = _with_first_modulus(tmp_path)
    judged = []

    class Spy(ckks.Decryptor):
        def decrypt(self, data, level, sdeg, slots):
            judged.append((np.array(data), level, sdeg, slots))
            return super().decrypt(data, level, sdeg, slots)

    monkeypatch.setattr(harness, "Decryptor", Spy)
    res, _ = harness.run_cell(Q0_CELL, 2**31 + 2024, 0.05, False, time.perf_counter(),
                              device="cpu", root=root, log=lambda m: None)
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["chain_primes_off"]["value"] == 0
    _, config, mix = harness.resolve(harness.load_benchmark(root), Q0_CELL, root)
    params = config["params"]
    assert ckks.chain(params["ring_n"], params["mult_depth"], params["scale_bits"],
                      params["comp"], params["base_limbs"], 30)[0][0] > 2**29
    vecs = traffic.vectors(mix, config["n"], 2**31 + 2024)
    keyless = ckks.Decryptor({k: v for k, v in params.items() if k != "first_mod_bits"},
                             traffic.secret(params["ring_n"], 2**31 + 2024))
    assert judged
    for k, (data, level, sdeg, slots) in enumerate(judged):
        got = keyless.decrypt(data, level, sdeg, slots)[: config["n"]]
        err = np.abs(got - np.sort(vecs[k % len(vecs)])).max()
        assert not err <= config["limits"]["max_abs_err"]


def test_a_bootstrapped_sort_runs_from_new_files_alone(tmp_path, monkeypatch):
    """The k-way network with real refreshes (the uniform-secret shape, the
    k-way chain with its 30-bit first modulus) at ring 256, where that shape
    is correct: a refresh fires in every sort, the key set holds the
    conjugation key, and the wide mix's answers lie 0.1 apart."""
    root = tiny_kway.make(tmp_path)
    made, real = [], harness.builder

    def spy(name, root=harness.ROOT):
        mod = real(name, root)

        class Sort(mod.Sort):
            def __init__(self, ev, config):
                super().__init__(ev, config)
                made.append((self, set(ev.keys.rot)))

        mod.Sort = Sort
        return mod

    monkeypatch.setattr(harness, "builder", spy)
    res, lines = harness.run_cell(tiny_kway.CELL, 2**31 + 99, 0.05, False, time.perf_counter(),
                                  device="cpu", root=root, log=lambda m: None)
    line = json.loads(json.dumps(res))
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["checks"]["chain_primes_off"]["value"] == 0
    assert line["checks"]["logqp_bits"]["value"] <= 3524
    (srt, held), = made
    assert 2 * tiny_kway.CONFIG["params"]["ring_n"] - 1 in held
    assert len(srt.fired) == tiny_kway.MIX["warmup_sorts"] + line["attempted"]
    assert min(srt.fired) >= 1
    assert traffic.answer_gap(tiny_kway.MIX, tiny_kway.CONFIG["n"]) >= 0.1
    assert set(line["metrics"]) == {"sort_s", "precision_bits", "setup_s"}
