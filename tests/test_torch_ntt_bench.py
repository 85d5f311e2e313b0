"""The port's NTT microbenchmark (`fhe_sorting_tpu_torch/utils/ntt_bench.py`)
on the CPU, at ring 2^10 (a square 32 x 32 four-step split), 3 limbs, one
iteration, depth 4: the plain four-step equals the plain
butterfly bit for bit, forward and inverse, the kernels' rows say they were not run, and
the rotation and multiplication lines are printed."""

import torch

from fhe_sorting_tpu_torch.utils import ntt_bench

torch.set_num_threads(2)


def test_ntt_bench_on_cpu(capsys):
    ntt_bench.main(["--ring", "1024", "--limbs", "3", "--iters", "1", "--depth", "4",
                    "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    exact = {ln.split("(")[1].split(")")[0]: ln.split(": ", 1)[1]
             for ln in lines if ln.startswith("bit-exact match")}
    assert exact == {"four-step": "True", "K2": ntt_bench.NOT_RUN, "K1": ntt_bench.NOT_RUN,
                     "four-step inverse": "True", "K2 inverse": ntt_bench.NOT_RUN,
                     "K1 inverse": ntt_bench.NOT_RUN}
    rows = {ln.split()[0]: ln for ln in lines if ln.startswith(("ntt/", "intt/"))}
    assert len(rows) == 8
    for name, ln in rows.items():
        if "/K" in name:
            assert ln.endswith(ntt_bench.NOT_RUN)
        else:
            assert " ms " in ln and "share not measured on the CPU" in ln
    assert any(ln.startswith("rotate(keyswitch): measured") for ln in lines)
    assert any(ln.startswith("mult(ct,ct)+relin: measured") for ln in lines)
    assert not any("% of SoL" in ln for ln in lines)
