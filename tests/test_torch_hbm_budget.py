"""The port's static device-memory accounting against real tensors of the
port: a key and a ciphertext take exactly the bytes it reckons (int64
planes), and a phase over budget raises before anything is allocated.  Also
what the accounting assumes: a Chebyshev evaluation frees its temporaries
when it returns, without waiting for the cyclic collector."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.utils import hbm_budget as hb

torch.set_num_threads(2)

PARAMS = {
    "comp1": dict(ring_n=256, mult_depth=5),
    "short": dict(ring_n=256, mult_depth=2),          # fewer digits than dnum
    "comp2": dict(ring_n=512, mult_depth=4, scale_bits=56, comp=2, base_limbs=4, dnum=2),
}


@pytest.fixture(scope="module", params=sorted(PARAMS))
def env(request):
    ctx = Context(CkksParams(**PARAMS[request.param]), device="cpu")
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys([1])
    return ctx, keys


def _nbytes(t):
    return t.numel() * t.element_size()


def test_ksk_bytes_is_a_real_key(env):
    ctx, keys = env
    for ksk in [keys.relin, *keys.rot.values()]:
        assert hb.ksk_bytes(ctx) == _nbytes(ksk.kb) + _nbytes(ksk.ka)


def test_ct_bytes_is_a_real_ciphertext(env):
    ctx, keys = env
    for level in (0, 1, ctx.params.mult_depth):
        ct = keys.encrypt(np.arange(4) / 4.0, level=level, seed=1)
        assert hb.ct_bytes(ctx, level) == _nbytes(ct.data)
    assert hb.RESIDUE_BYTES == keys.relin.kb.element_size() == 8


def test_phase_bytes_adds_up(env):
    ctx, _ = env
    k, c = hb.ksk_bytes(ctx), hb.ct_bytes(ctx, 0)
    assert hb.phase_bytes(ctx, 3, 2) == 4 * k + 6 * c
    assert hb.phase_bytes(ctx, 3, 2, relin=False, work_cts=0) == 3 * k + 2 * c


def test_check_phase_report_and_raise(env):
    ctx, _ = env
    used = hb.phase_bytes(ctx, 5, 2)
    fits_gb = used / (1 << 30) / (1 - hb.DEFAULT_HEADROOM_FRAC)
    rep = hb.check_phase(ctx, 5, 2, capacity_gb=fits_gb * 1.01, label="ok")
    assert rep["fits"] and rep["n_rot_keys"] == 5 and rep["label"] == "ok"
    assert rep["ksk_mb"] == round(hb.ksk_bytes(ctx) / (1 << 20), 1)
    with pytest.raises(MemoryError, match="tight needs"):
        hb.check_phase(ctx, 5, 2, capacity_gb=fits_gb * 0.99, label="tight")
    # the headroom is part of the budget
    with pytest.raises(MemoryError):
        hb.check_phase(ctx, 5, 2, capacity_gb=fits_gb * 1.01, headroom_frac=0.5)


def test_cpu_context_has_no_capacity_to_read(env):
    ctx, _ = env
    with pytest.raises(ValueError, match="capacity_gb"):
        hb.check_phase(ctx, 1, 1)
    with pytest.raises(ValueError):
        hb.device_capacity_gb(ctx)


def test_chebyshev_ps_frees_its_temporaries_without_gc():
    """`ChebyshevPS.evaluate` holds no reference cycle: with the cyclic
    collector off, every leaf it made is freed once the result is dropped (at
    N=1024, ring 2^17 the leaves of one sinc evaluation are 4.7 GB)."""
    import gc
    import weakref

    from fhe_sorting_tpu_torch.core.evaluator import Evaluator
    from fhe_sorting_tpu_torch.ops.chebyshev import ChebyshevPS, chebyshev_fit

    ctx = Context(CkksParams(ring_n=256, mult_depth=5), device="cpu")
    keys = Keys.generate(ctx, seed=0)
    ev = Evaluator(ctx, keys)
    refs = []
    combo = ev.combo

    def spy(cts, rows, consts):
        out = combo(cts, rows, consts)
        refs.extend(weakref.ref(c.data) for c in out)
        return out

    ev.combo = spy
    x = keys.encrypt(np.linspace(-0.9, 0.9, 8), seed=1)
    gc.collect()
    gc.disable()
    try:
        out = ChebyshevPS(ev).evaluate(x, chebyshev_fit(np.tanh, 7))
        assert refs and np.all(np.isfinite(keys.decrypt(out, 8)))
        del out
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
