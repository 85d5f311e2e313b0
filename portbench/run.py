"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 -m portbench.run ...                      (the same)

Measures `fhe_sorting_tpu_torch` on the first CUDA card(s): the cell's
configuration and traffic are found by name in `BENCHMARK.json` (see
`harness.py`).  Prints `# ` lines and each number compared with its limit on
standard error, and one JSON object as the last line of standard output.
Exits 2 without a result where there is no CUDA card or fewer than the cell
asks for, and 3 where the process holds JAX or the JAX package once the
window has closed.  Every build and kernel cache stays inside the checkout:
the program builds its kernels into `fhe_sorting_tpu_torch/_build/`, and
the caches PyTorch, Triton and the CUDA driver could write go to
`.portbench_cache/`.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CACHE = os.path.join(ROOT, ".portbench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _card() -> str:
    """The card's name and power limit, where nvidia-smi answers."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no answer"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.resolve(harness.load_benchmark(ROOT), args.workload, ROOT)[0]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        _log(f"portbench: the cell {args.workload} needs {cell['chips']} CUDA card(s); "
             f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    _log(f"# card: {_card()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result, checks = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                      T_START, log=_log)
    held = harness.forbidden_modules(sys.modules)
    if held:
        _log(f"portbench: the process holds {', '.join(held)} after the window: no result")
        return 3
    for line in checks:
        _log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
