"""The port's hand-written CUDA kernel K1 and the port's import hygiene.

K1 against its plain PyTorch version needs a CUDA device and nvcc: marked
`cuda`, it skips elsewhere (the card runs it, and `chip_smoke.py` runs the
same comparison at the main path's shapes).  The import test runs here:
the port must import no JAX, which only a fresh interpreter can show
(tests/conftest.py imports JAX)."""

import subprocess
import sys

import pytest
import torch


@pytest.mark.cuda
@pytest.mark.parametrize("ring,limbs", [(1 << 12, 3), (1 << 17, 4)])
def test_k1_matches_plain_on_card(ring, limbs):
    if not torch.cuda.is_available():
        pytest.skip("K1 is a CUDA kernel: needs a CUDA device")
    from fhe_sorting_tpu_torch.core import fs_ntt, ntt_mxu, primes

    ps = primes.ntt_primes(ring, 28, limbs)
    t = ntt_mxu.build_fs_tables(ps, ring, "cuda")
    n1, n2 = ntt_mxu.split_n(ring)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.remainder(torch.randint(0, 1 << 62, (2, limbs, n1, n2), generator=gen,
                                      device="cuda"), t.p)
    before = fs_ntt.launches
    fwd = fs_ntt.four_step(x, t, None, inverse=False)
    inv = fs_ntt.four_step(fwd, t, None, inverse=True)
    assert fs_ntt.launches == before + 4
    assert torch.equal(fwd, ntt_mxu.ntt_plain(x, t, None, False))
    assert torch.equal(inv, ntt_mxu.ntt_plain(fwd, t, None, True))
    assert torch.equal(inv, x)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import fhe_sorting_tpu_torch\n"
        "import fhe_sorting_tpu_torch.core.fs_ntt\n"
        "import fhe_sorting_tpu_torch.parallel.direct_staged\n"
        "import fhe_sorting_tpu_torch.utils.depth_meter\n"
        "import fhe_sorting_tpu_torch.utils.params_registry\n"
        "from fhe_sorting_tpu_torch.core.evaluator import Evaluator\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True)
