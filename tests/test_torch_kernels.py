"""The port's hand-written CUDA kernels K1, K2 and K3, the NTT a default context
runs on the card, and the port's import hygiene.

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

import numpy as np
import pytest
import torch

from fhe_sorting_tpu_torch.core import cuda_build

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _only(key, n):
    """The launch counter's delta where kernel `key` alone launched n times."""
    return {k: n if k == key else 0 for k in cuda_build.KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("ring,limbs,batch,subset", [
    (1 << 12, 3, 2, None), (1 << 14, 3, 2, None), (1 << 17, 4, 2, None),
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
    before = cuda_build.counts()
    fwd = fs_ntt.four_step(x, t, sel, inverse=False)
    inv = fs_ntt.four_step(fwd, t, sel, inverse=True)
    torch.cuda.synchronize()
    assert cuda_build.since(before) == _only("k1", 4)
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
    before = cuda_build.counts()
    fwd = bf_ntt.butterfly(x, t, limbs, inverse=False)
    inv = bf_ntt.butterfly(fwd, t, limbs, inverse=True)
    torch.cuda.synchronize()
    assert cuda_build.since(before) == _only("k2", 2)     # one launch a transform
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
    before = cuda_build.counts()
    assert torch.equal(ntt.ntt(x, t, limbs), fwd)
    assert cuda_build.since(before)["k2"] > 0
    with pytest.raises(ValueError):
        bf_ntt.butterfly(x.to(torch.int32), t, limbs, inverse=False)



def _k3_case(ring, r, bits, B, subset, seed):
    """(x, q, kept primes [r', 1], a view [:, :r'] of larger planes, b) on
    the card for K3: r + 1 primes, the last one dropped, the kept rows every
    one or, for a limb rank's, those `subset` picks; x holds the centring's
    edges, a and b the residues 0 and p - 1."""
    from fhe_sorting_tpu_torch.core import primes

    ps = primes.ntt_primes(ring, bits, r + 1)
    q, kept = ps[-1], list(ps[:-1])[subset]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.tensor(kept, dtype=torch.int64, device="cuda")[:, None]
    x = torch.randint(0, q, (B, 1, ring), generator=gen, device="cuda")
    half = (q + 1) // 2
    x[0, 0, :5] = torch.tensor([0, 1, half - 1, half, q - 1], device="cuda")
    m = len(kept)
    big = torch.remainder(torch.randint(0, 1 << 62, (B, m + 3, ring), generator=gen,
                                        device="cuda"), torch.cat([p, p[:3]]))
    b = torch.remainder(torch.randint(0, 1 << 62, (B, m, ring), generator=gen, device="cuda"), p)
    big[:, :m, 0], b[:, :, 1] = 0, (p - 1)[:, 0]
    return x, q, kept, p, big[:, :m], b


@pytest.mark.cuda
@pytest.mark.parametrize("ring,r,bits,B,subset", [
    (1 << 17, 67, 30, 2, slice(None)),        # direct_n128's first rescale: 68 limbs
    (1 << 17, 95, 30, 2, slice(None)),        # mehp24_n512's: 96 limbs
    (1 << 17, 5, 28, 2, slice(None)),         # a deep level
    (1 << 17, 67, 30, 1, slice(None)),        # B = 1
    (1 << 17, 67, 31, 2, slice(1, None, 2)),  # one of two limb ranks' rows, 31-bit primes
    (1 << 12, 3, 28, 2, slice(None)),         # a small ring: one block a row
])
def test_k3_matches_plain_on_card(ring, r, bits, B, subset):
    """K3's lift and sub_scale against their plain versions, bit for bit, at
    the cells' top-of-chain shapes, a deep level, B = 1, a limb rank's rows
    and a small ring, with `a` a strided view and the rows' constants
    contiguous or strided; one launch each; zero rows launch nothing; no
    fallback for what the kernel does not take."""
    if not torch.cuda.is_available():
        pytest.skip("K3 is a CUDA kernel: needs a CUDA device")
    from fhe_sorting_tpu_torch.core import rns_div

    x, q, kept, p, a, b = _k3_case(ring, r, bits, B, subset, ring + r)
    c = torch.remainder(torch.tensor(q, device="cuda"), p)
    w = torch.tensor([[pow(q, -1, pi)] for pi in kept], dtype=torch.int64, device="cuda")
    half = (q + 1) // 2
    assert B == 1 or not a.is_contiguous()
    # the constants as the limb-parallel rows hold them: strided views [r, 1]
    cw = torch.cat([c, w, p], dim=1)
    cv, wv, pv = cw[:, 0:1], cw[:, 1:2], cw[:, 2:3]
    assert pv.stride(0) == 3
    before = cuda_build.counts()
    t = rns_div.lift(x, p, c, half)
    out = rns_div.sub_scale(a, b, p, w)
    torch.cuda.synchronize()
    assert cuda_build.since(before) == _only("k3", 2)
    assert torch.equal(t, rns_div.lift_plain(x, p, c, half))
    assert torch.equal(out, rns_div.sub_scale_plain(a, b, p, w))
    assert torch.equal(rns_div.lift(x, pv, cv, half), t)
    assert torch.equal(rns_div.sub_scale(a, b, pv, wv), out)
    assert rns_div.lift(x, p[:0], c[:0], half).shape == (B, 0, ring)
    assert rns_div.sub_scale(a[:, :0], b[:, :0], p[:0], w[:0]).shape == (B, 0, ring)
    assert cuda_build.since(before) == _only("k3", 4)
    with pytest.raises(ValueError):       # every other residue: no plain fallback
        rns_div.sub_scale(a[..., ::2], b[..., ::2], p, w)
    with pytest.raises(ValueError):
        rns_div.lift(x.to(torch.int32), p, c, half)


@pytest.mark.cuda
def test_k3_in_evaluator_and_graphs_on_card():
    """A rescale (comp 2: two dropped limbs) and a ModDown on the card give
    the CPU evaluator's planes on the same inputs, through K3 (two launches a
    dropped limb, one a ModDown, no int64 remainder left); a stage of two
    rescales on a CUDA graph replays to the eager planes, and its replay
    advances the launch counter's `k3` and its span's `k3` as the eager call
    did."""
    if not torch.cuda.is_available():
        pytest.skip("K3 is a CUDA kernel: needs a CUDA device")
    from fhe_sorting_tpu_torch.core import rns_div, trace
    from fhe_sorting_tpu_torch.core.cipher import Ciphertext
    from fhe_sorting_tpu_torch.core.context import CkksParams, Context
    from fhe_sorting_tpu_torch.core.evaluator import Evaluator
    from fhe_sorting_tpu_torch.core.keys import Keys
    from fhe_sorting_tpu_torch.parallel.whole_graph import WholeGraph

    params = CkksParams(ring_n=1 << 12, mult_depth=4, scale_bits=56, comp=2, base_limbs=4)
    evs = {}
    for dev in ("cpu", "cuda"):
        ctx = Context(params, device=dev)
        evs[dev] = Evaluator(ctx, Keys.generate(ctx, seed=0))
    ctx = evs["cpu"].ctx
    level, n = 1, params.ring_n
    rng = np.random.default_rng(0)
    ps = np.array(ctx.all_primes, dtype=np.int64)
    data = rng.integers(0, 1 << 62, (2, ctx.limbs_at(level), n)) % ps[:ctx.limbs_at(level), None]
    c = rng.integers(0, 1 << 62, (2, ctx.limbs_at(level) + ctx.num_sp, n))
    c %= np.concatenate([ps[:ctx.limbs_at(level)], ps[ctx.num_q:]])[:, None]
    got = {}
    for dev, ev in evs.items():
        before = cuda_build.counts()
        ct = Ciphertext(torch.from_numpy(data).to(dev), level, 2, n // 2)
        got[dev] = (ev.rescale(ct).data, ev._moddown(torch.from_numpy(c).to(dev), level))
        torch.cuda.synchronize()
        assert cuda_build.since(before)["k3"] == (0 if dev == "cpu" else 2 * params.comp + 1)
    for g_cpu, g_card in zip(got["cpu"], got["cuda"]):
        assert torch.equal(g_card.cpu(), g_cpu)

    ev = evs["cuda"]
    ct = Ciphertext(torch.from_numpy(data).cuda(), level, 2, n // 2)
    stage = WholeGraph(ev, lambda cts: ev.rescale(ev.mult(ev.rescale(cts[0]), 1.0)),
                       name="k3.rescales")
    want = stage([ct])                                  # eager, then the capture
    launched = []
    with trace.recording():
        for _ in range(2):
            before = cuda_build.counts()
            out = stage([ct])                           # replays
            torch.cuda.synchronize()
            launched.append(cuda_build.since(before)["k3"])
            assert torch.equal(out.data, want.data)
    spans = [s for s in trace.spans() if s.name == "k3.rescales"]
    assert launched == [4 * params.comp] * 2
    assert [(s.counts["kind"], s.counts["k3"]) for s in spans] == [("replay", 4 * params.comp)] * 2


@pytest.mark.cuda
def test_auto_runs_k2_on_card():
    """A context on the card with the default NTT ("auto") at a ring K1 tiles
    (2^15) holds the butterfly's tables, and an eager staged DirectSort on it
    launches K2 and no K1, and sorts."""
    if not torch.cuda.is_available():
        pytest.skip("K2 is a CUDA kernel: needs a CUDA device")
    from fhe_sorting_tpu_torch.core.context import CkksParams, Context
    from fhe_sorting_tpu_torch.core.evaluator import Evaluator
    from fhe_sorting_tpu_torch.core.keys import Keys
    from fhe_sorting_tpu_torch.core.ntt import NttTables
    from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig
    from fhe_sorting_tpu_torch.parallel.direct_staged import (
        StagedDirectSort, scan_rotation_indices)
    from fhe_sorting_tpu_torch.utils.depth_meter import measure_direct_sort_depth

    n, ring = 8, 1 << 15
    cfg = SignConfig(CompositeSignConfig(3, 2, 2))
    depth = measure_direct_sort_depth(n, ring, cfg)["mult_depth"]
    ctx = Context(CkksParams(ring_n=ring, mult_depth=depth))
    assert ctx.ntt_impl == "butterfly" and isinstance(ctx.tables, NttTables)
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys(sorted(scan_rotation_indices(n, ring)))
    vals = np.random.default_rng(0).permutation(n) / n + 0.5 / n
    ct = keys.encrypt(vals, seed=1)
    before = cuda_build.counts()
    out = StagedDirectSort(Evaluator(ctx, keys), n, cfg, graphs=False)(ct)
    torch.cuda.synchronize()
    launched = cuda_build.since(before)
    assert launched["k2"] > 0 and launched["k1"] == 0
    assert float(np.abs(keys.decrypt(out, n) - np.sort(vals)).max()) < 0.01


def test_port_imports_no_jax():
    """In a fresh interpreter, importing every module of the port (and
    `chip_smoke`) loads neither JAX nor any module of the JAX package, nor
    the JAX package's scripts (`bench`, `benchmarks`)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fhe_sorting_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(names) > 20, names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'fhe_sorting_tpu', 'bench',\n"
        "                                              'benchmarks')\n"
        "             or m.startswith(('jax.', 'jaxlib.', 'fhe_sorting_tpu.', 'benchmarks.')))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=_ROOT)


def test_port_sources_name_no_jax_import():
    """No source of the port, nor `chip_smoke.py`, has an import statement
    that names JAX, the JAX package or its scripts (docstrings may cite
    counterparts)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|fhe_sorting_tpu|bench|benchmarks)(\.|\s|$)")
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(_ROOT, "fhe_sorting_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            hits = [line for line in f if pat.match(line)]
        assert not hits, (path, hits)
