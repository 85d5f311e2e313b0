"""What nvcc made of the port's kernels: `cuobjdump -sass` of K1 and K2, counted.

    python -m fhe_sorting_tpu_torch.utils.kernel_sass

Needs nvcc and cuobjdump (no card).  Builds `csrc/fs_ntt.cu` and
`csrc/bf_ntt.cu` and prints, per compiled kernel, its instruction count and
most frequent opcodes.  For K1 it checks that the matrix products are tensor
core instructions (`IMMA`); for K2 it prints the instructions per butterfly,
taking one `IMAD.HI` (the Shoup quotient) as one butterfly.
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys

from ..core import cuda_build

_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)")


def kernels(name: str) -> dict:
    """{mangled kernel name: Counter of opcodes} of `csrc/<name>.cu`."""
    cuda_build.build([name])
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", cuda_build._paths(name)[1]],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        ops = collections.Counter()
        for line in chunk.splitlines()[1:]:
            m = _INSTR.search(line)
            if m:
                op = m.group(1)
                ops[op if op.startswith(("IMAD.HI", "IMAD.WIDE", "IMMA", "IGMMA")) else
                    op.split(".")[0]] += 1
        out[chunk.splitlines()[0].strip()] = ops
    return out


def main() -> int:
    for name in ("fs_ntt", "bf_ntt"):
        for kern, ops in kernels(name).items():
            total = sum(ops.values())
            tensor = sum(n for op, n in ops.items() if op.startswith(("IMMA", "IGMMA")))
            # the end of the mangled name carries the template arguments
            line = f"# {name}.cu ..{kern[-44:]}: {total} instructions"
            if name == "fs_ntt":
                if not tensor:
                    raise AssertionError(f"{kern}: no tensor-core instruction in K1")
                line += (f", {tensor} IMMA/IGMMA, "
                         f"{sum(n for op, n in ops.items() if op.startswith('IMAD.WIDE'))} IMAD.WIDE")
            else:
                hi = sum(n for op, n in ops.items() if op.startswith("IMAD.HI"))
                line += f", {hi} IMAD.HI, {total / max(hi, 1):.1f} instructions per IMAD.HI"
            print(line)
            print("#    " + ", ".join(f"{op} {n}" for op, n in ops.most_common(12)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
