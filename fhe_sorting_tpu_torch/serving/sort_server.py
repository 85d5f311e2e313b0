"""Serving entry point: blind sort of a serialized ciphertext.

Port of `serving/sort_server.py` (the blind-sorting deployment shape): the
server loads a crypto context, evaluation keys and an input ciphertext from
files, never a secret key, runs the chosen sort and writes the output
ciphertext.  Anything that fails (no CUDA device, a kernel that does not
build, a missing rotation key) ends the process with an error and no output
file.

Usage:
  python -m fhe_sorting_tpu_torch.serving.sort_server --cc cc.json \
      --keys keys.npz --input in.npz --output out.npz --n 128 \
      [--algo direct|bitonic|mehp24] [--device cuda:0]

`--device` defaults to the first CUDA card and raises where there is none;
`--device cpu` runs the plain PyTorch NTTs.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..core.evaluator import Evaluator
from ..core.serialize import load_ciphertext, load_context, load_eval_keys, save_ciphertext
from ..ops.sign import CompositeSignConfig, SignConfig, SignFunc

ALGOS = ("direct", "bitonic", "mehp24")


def _algo(name: str) -> str:
    if name == "kway":
        raise argparse.ArgumentTypeError(
            "the k-way sort is not ported to this package yet (ROADMAP.md, "
            "milestone M9); use the JAX package's serving/sort_server.py for it")
    if name not in ALGOS:
        raise argparse.ArgumentTypeError(f"choose from {', '.join(ALGOS)}")
    return name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cc", required=True, help="context json")
    ap.add_argument("--keys", required=True, help="evaluation keys npz")
    ap.add_argument("--input", required=True, help="input ciphertext npz")
    ap.add_argument("--output", required=True, help="output ciphertext npz")
    ap.add_argument("--n", type=int, required=True, help="array size")
    ap.add_argument("--algo", default="direct", type=_algo, help="|".join(ALGOS))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    # default: the params registry's per-N choice (a registry default cannot
    # exceed the depth the context was provisioned for)
    ap.add_argument("--sign_n", type=int, default=None)
    ap.add_argument("--dg", type=int, default=None)
    ap.add_argument("--df", type=int, default=None)
    args = ap.parse_args(argv)

    if args.sign_n is None or args.dg is None or args.df is None:
        from ..utils.params_registry import direct_sort_sign_cfg

        cn, dg, df = direct_sort_sign_cfg(args.n)
        args.sign_n = args.sign_n if args.sign_n is not None else cn
        args.dg = args.dg if args.dg is not None else dg
        args.df = args.df if args.df is not None else df

    ctx = load_context(args.cc, device=args.device)
    keys = load_eval_keys(args.keys, ctx)
    ct = load_ciphertext(args.input, ctx.device)
    ev = Evaluator(ctx, keys)

    if args.algo == "direct":
        from ..models.direct_sort import DirectSort

        sorter = DirectSort(ev, args.n)
    elif args.algo == "bitonic":
        from ..models.bitonic import BitonicSort

        sorter = BitonicSort(ev, args.n, normalize=1.0)
    else:
        from ..models.mehp24 import Mehp24Sort

        sorter = Mehp24Sort(ev, args.n)

    cfg = SignConfig(CompositeSignConfig(args.sign_n, args.dg, args.df))
    t0 = time.time()
    out = sorter.sort(ct, SignFunc.CompositeSign, cfg)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    print(f"sorted N={args.n} with {args.algo} in {time.time()-t0:.2f}s",
          file=sys.stderr)
    save_ciphertext(args.output, out)


if __name__ == "__main__":
    main()
