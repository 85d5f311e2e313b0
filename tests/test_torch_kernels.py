"""The port's hand-written CUDA kernels K1 and K2, and its import hygiene.

The kernels against their plain PyTorch versions need a CUDA device and
nvcc: marked `cuda`, they skip elsewhere (the card runs them, and
`chip_smoke.py` runs the same comparisons at the main path's shapes).  The
import tests run here: the port must import neither JAX nor the JAX package,
which only a fresh interpreter can show (tests/conftest.py imports JAX)."""

import dataclasses
import os
import re
import subprocess
import sys

import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.cuda
@pytest.mark.parametrize("ring,limbs,batch,subset", [
    (1 << 12, 3, 2, None), (1 << 17, 4, 2, None),
    (1 << 12, 4, 1, None), (1 << 15, 4, 2, (3, 0, 2)), (1 << 17, 4, 1, (2, 1)),
])
def test_k1_matches_plain_on_card(ring, limbs, batch, subset):
    """K1 forward and inverse against the plain four-step, bit for bit, with
    its eight-warp and four-warp tiles, B = 1 and a limb subset, the edge
    residues 0 and p - 1, and the round trip."""
    if not torch.cuda.is_available():
        pytest.skip("K1 is a CUDA kernel: needs a CUDA device")
    from fhe_sorting_tpu_torch.core import fs_ntt, ntt_mxu, primes

    ps = primes.ntt_primes(ring, 30 if ring >= 1 << 15 else 28, limbs)
    t = ntt_mxu.build_fs_tables(ps, ring, "cuda")
    n1, n2 = ntt_mxu.split_n(ring)
    sel = None if subset is None else torch.tensor(subset, device="cuda")
    p = t.p if sel is None else t.p[sel]
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.remainder(torch.randint(0, 1 << 62, (batch, p.shape[0], n1, n2), generator=gen,
                                      device="cuda"), p)
    x[0, 0, 0, :4] = torch.tensor([0, 1, int(p[0]) - 1, 0], device="cuda")
    x[0, -1] = p[-1] - 1                      # a whole plane of the largest residue
    before = fs_ntt.launches
    fwd = fs_ntt.four_step(x, t, sel, inverse=False)
    inv = fs_ntt.four_step(fwd, t, sel, inverse=True)
    torch.cuda.synchronize()
    assert fs_ntt.launches == before + 4
    assert torch.equal(fwd, ntt_mxu.ntt_plain(x, t, sel, False))
    assert torch.equal(inv, ntt_mxu.ntt_plain(fwd, t, sel, True))
    assert torch.equal(inv, x)
    with pytest.raises(ValueError):       # tables without the kernel-side copy: no fallback
        fs_ntt.four_step(x, dataclasses.replace(t, kern=None), sel, inverse=False)


@pytest.mark.cuda
@pytest.mark.parametrize("ring,bits,subset", [
    (1 << 10, 28, None), (1 << 12, 30, None), (1 << 13, 28, (2, 0)),
    (1 << 14, 30, None), (1 << 17, 28, None), (1 << 17, 30, (3, 1, 0)),
    (1 << 12, 31, None), (1 << 15, 31, (1, 2)), (1 << 17, 31, None),
])
def test_k2_matches_plain_on_card(ring, bits, subset):
    """K2 forward and inverse against the plain butterfly, bit for bit, on one
    block (n <= 2^14) and on a cluster, one launch a transform either way,
    with and without a limb subset, every cluster size the kernel accepts,
    and the round trip."""
    if not torch.cuda.is_available():
        pytest.skip("K2 is a CUDA kernel: needs a CUDA device")
    from fhe_sorting_tpu_torch.core import bf_ntt, ntt, primes

    ps = primes.ntt_primes(ring, bits, 4)
    t = ntt.build_device_tables(ps, ring, "cuda")
    assert t.lazy == (bits <= 30)
    limbs = None if subset is None else torch.tensor(subset, device="cuda")
    L = 4 if subset is None else len(subset)
    p = t.p if limbs is None else t.p[limbs]
    gen = torch.Generator(device="cuda").manual_seed(ring)
    x = torch.remainder(torch.randint(0, 1 << 62, (2, L, ring), generator=gen,
                                      device="cuda"), p)
    x[0, 0, :4] = torch.tensor([0, 1, int(p[0]) - 1, 0], device="cuda")   # edge residues
    before = bf_ntt.launches
    fwd = bf_ntt.butterfly(x, t, limbs, inverse=False)
    inv = bf_ntt.butterfly(fwd, t, limbs, inverse=True)
    torch.cuda.synchronize()
    assert bf_ntt.launches == before + 2                  # one launch a transform
    want_fwd = ntt.butterfly_plain(x, t, limbs, False)
    assert torch.equal(fwd, want_fwd)
    assert torch.equal(inv, ntt.butterfly_plain(fwd, t, limbs, True))
    assert torch.equal(inv, x)
    logn = ring.bit_length() - 1
    assert bf_ntt.max_active_clusters(logn, bf_ntt.cluster_log(logn)) > 0
    idx = torch.arange(L, device="cuda") if limbs is None else limbs
    for c in range(bf_ntt.MAX_LOG_CLUSTER + 1):
        if 1 + c <= logn - c <= bf_ntt.LOG_CHUNK:
            assert torch.equal(bf_ntt._launch(x, t, idx, False, c), want_fwd)
            assert torch.equal(bf_ntt._launch(want_fwd, t, idx, True, c), x)
    # the routing: ntt/intt with butterfly tables launch K2 on a CUDA tensor
    before = bf_ntt.launches
    assert torch.equal(ntt.ntt(x, t, limbs), fwd)
    assert bf_ntt.launches > before
    with pytest.raises(ValueError):
        bf_ntt.butterfly(x.to(torch.int32), t, limbs, inverse=False)


def test_port_imports_no_jax():
    """In a fresh interpreter, importing every module of the port (and
    `chip_smoke`) loads neither JAX nor any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fhe_sorting_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(names) > 20, names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'fhe_sorting_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib.', 'fhe_sorting_tpu.')))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=_ROOT)


def test_port_sources_name_no_jax_import():
    """No source of the port, nor `chip_smoke.py`, has an import statement
    that names JAX or the JAX package (docstrings may cite counterparts)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|fhe_sorting_tpu)(\.|\s|$)")
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(_ROOT, "fhe_sorting_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            hits = [line for line in f if pat.match(line)]
        assert not hits, (path, hits)
