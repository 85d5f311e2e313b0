"""The readings a cell's limits are set from: the program over many seeds, and its control.

    python3 -m portbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--control]

Runs the cell once per seed in this one process (set-up, a window of
`--seconds`, the check against the reference), as `run.py` does, and
prints one JSON line per seed with the numbers `correct` compares and
the seconds a sort took.  `--control` runs the program's lower-precision
path that the configuration's `control` names (its `params` replace the
configuration's), which has to come out as not correct.  The benchmark's
own runs never run this.  Needs a CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.run import ROOT, _card, _log  # noqa: E402


def readings(workload: str, seeds, seconds: float, control: bool, device: str = "cuda",
             root: str = ROOT, log=_log) -> list:
    import torch

    over = None
    if control:
        _, config, _ = harness.resolve(harness.load_benchmark(root), workload, root)
        over = config["control"]["params"]
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        try:
            res, _ = harness.run_cell(workload, seed, seconds, False, t0, device=device,
                                      root=root, params_over=over, log=log)
            row = {"seed": seed, "control": control, "correct": res["correct"],
                   "attempted": res["attempted"], "failed": res["failed"],
                   **{k: v["value"] for k, v in res["checks"].items()},
                   **{k: v["value"] for k, v in res["metrics"].items()}}
        except (RuntimeError, ValueError, AssertionError, OverflowError) as exc:
            # a control that fails outright has failed: it gives no reading
            row = {"seed": seed, "control": control, "correct": False, "error": repr(exc)[:400]}
        print(json.dumps(row), flush=True)
        out.append(row)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        _log("portbench.control: no CUDA card")
        return 2
    _log(f"# card: {_card()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    readings(args.workload, args.seeds, args.seconds, args.control)
    return 0


if __name__ == "__main__":
    sys.exit(main())
