"""The port's file boundary (`core/serialize.py`) against the JAX package's:
round trips, the context fields the reference's `save_context` drops, and
files crossing between the packages in both directions with bit-equal
contents (tolerance 0).  Residues are uint32 in every file."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core import serialize as jser
from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.evaluator import Evaluator as JEvaluator
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu_torch.core import serialize as tser
from fhe_sorting_tpu_torch.core.cipher import Ciphertext
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.evaluator import Evaluator
from fhe_sorting_tpu_torch.core.keys import Keys

torch.set_num_threads(2)

FLAGSHIP = dict(ring_n=256, mult_depth=3, scale_bits=56, comp=2, base_limbs=4,
                first_mod_bits=30, secret_hamming=64, ntt_impl="butterfly")


def _eq(t, j, what=""):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j).astype(np.int64), what)


def test_serialize_roundtrip(tmp_path):
    """The port's counterpart of the reference's round-trip test."""
    ctx = Context(CkksParams(ring_n=256, mult_depth=6), device="cpu")
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys([1, 2])

    tser.save_context(str(tmp_path / "cc.json"), ctx)
    ctx2 = tser.load_context(str(tmp_path / "cc.json"), device="cpu")
    assert ctx2.q_primes == ctx.q_primes and ctx2.params == ctx.params

    tser.save_eval_keys(str(tmp_path / "keys.npz"), keys)
    keys2 = tser.load_eval_keys(str(tmp_path / "keys.npz"), ctx2)
    assert keys2.s_eval is None and keys2.s_coeffs is None   # the server never holds a secret
    assert set(keys2.rot) == set(keys.rot)
    assert torch.equal(keys2.relin.kb, keys.relin.kb) and torch.equal(keys2.relin.ka, keys.relin.ka)
    for g in keys.rot:
        assert torch.equal(keys2.rot[g].kb, keys.rot[g].kb)
        assert torch.equal(keys2.rot[g].ka, keys.rot[g].ka)

    x = np.arange(8) / 8.0
    ct = keys.encrypt(x)
    tser.save_ciphertext(str(tmp_path / "ct.npz"), ct)
    ct2 = tser.load_ciphertext(str(tmp_path / "ct.npz"), "cpu")
    assert torch.equal(ct2.data, ct.data) and ct2.data.dtype == torch.int64
    assert (ct2.level, ct2.sdeg, ct2.slots) == (ct.level, ct.sdeg, ct.slots)

    # server-side evaluation with deserialized keys decrypts correctly
    ev = Evaluator(ctx2, keys2)
    out = ev.add(ev.rotate(ct2, 1), 0.5)
    np.testing.assert_allclose(keys.decrypt(out), np.roll(x, -1) + 0.5, atol=5e-5)
    # and a ciphertext encrypted by the server's public key decrypts at the client
    np.testing.assert_allclose(keys.decrypt(keys2.encrypt(x, seed=4)), x, atol=5e-5)


def test_files_hold_uint32_and_no_secret(tmp_path):
    ctx = Context(CkksParams(ring_n=256, mult_depth=2), device="cpu")
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys([3])
    tser.save_eval_keys(str(tmp_path / "keys.npz"), keys)
    tser.save_ciphertext(str(tmp_path / "ct.npz"), keys.encrypt([0.5], seed=0))
    g = ctx.galois_element_rot(3)
    with np.load(tmp_path / "keys.npz") as z:
        assert sorted(z.files) == sorted(
            ["pk_b", "pk_a", "relin_kb", "relin_ka", "rot_gs", f"rot_{g}_kb", f"rot_{g}_ka"])
        for name in z.files:
            assert z[name].dtype == (np.int64 if name == "rot_gs" else np.uint32), name
        assert z["relin_kb"].shape == (len(ctx.digit_layout(0)), ctx.num_q + ctx.num_sp, 256)
    with np.load(tmp_path / "ct.npz") as z:
        assert z["data"].dtype == np.uint32 and z["meta"].dtype == np.int64


@pytest.mark.parametrize("bad", [-1, 1 << 32])
def test_residue_outside_u32_is_refused(tmp_path, bad):
    data = torch.zeros((2, 3, 256), dtype=torch.int64)
    data[1, 2, 7] = bad
    with pytest.raises(ValueError, match="residue outside"):
        tser.save_ciphertext(str(tmp_path / "ct.npz"), Ciphertext(data, 0, 1, 8))
    assert not (tmp_path / "ct.npz").exists()


def test_every_context_field_round_trips(tmp_path):
    """comp=2, first_mod_bits=30, secret_hamming=64: equal params and primes."""
    ctx = Context(CkksParams(**FLAGSHIP, ksk_shoup=True), device="cpu")
    path = str(tmp_path / "cc.json")
    tser.save_context(path, ctx)
    with open(path) as f:
        assert set(json.load(f)) == {f.name for f in dataclasses.fields(CkksParams)}
    ctx2 = tser.load_context(path, device="cpu")
    assert ctx2.params == ctx.params
    assert ctx2.q_primes == ctx.q_primes and ctx2.sp_primes == ctx.sp_primes
    assert ctx2.ntt_impl == "butterfly"


def test_reference_save_context_drops_fields(tmp_path):
    """The documented fault of the reference that the port does not copy: its
    cc.json holds 7 of the 12 fields, so the composite-scaling chain does not
    come back (here the per-prime size assertion trips on reload)."""
    jctx = JContext(JParams(**FLAGSHIP))
    path = str(tmp_path / "cc.json")
    jser.save_context(path, jctx)
    with open(path) as f:
        kw = json.load(f)
    assert {"comp", "secret_hamming", "first_mod_bits", "ntt_impl", "ksk_shoup"}.isdisjoint(kw)
    with pytest.raises(AssertionError):
        jser.load_context(path)
    # a chain that survives the reload comes back with other primes
    jctx = JContext(JParams(ring_n=256, mult_depth=3, first_mod_bits=30))
    jser.save_context(path, jctx)
    assert jser.load_context(path).q_primes != jctx.q_primes
    # the port reads such a file with the dataclass defaults, as the reference does
    assert tser.load_context(path, device="cpu").q_primes == jser.load_context(path).q_primes


def test_unknown_context_field_is_refused(tmp_path):
    path = tmp_path / "cc.json"
    path.write_text(json.dumps({"ring_n": 256, "mult_depth": 2, "rings": 1}))
    with pytest.raises(ValueError, match="unknown context fields"):
        tser.load_context(str(path), device="cpu")


@pytest.fixture(scope="module")
def both():
    """One parameter set, JAX keys, and the same keys in the port."""
    params = dict(ring_n=256, mult_depth=4, scale_bits=56, comp=2, base_limbs=4,
                  first_mod_bits=30, secret_hamming=64, ntt_impl="butterfly")
    jctx = JContext(JParams(**params))
    jkeys = JKeys.generate(jctx, seed=0)
    jkeys.gen_rotation_keys([1, -2])
    jkeys.gen_conj_key()
    ctx = Context(CkksParams(**params), device="cpu")
    keys = Keys.from_numpy(
        ctx, jkeys.s_coeffs, jkeys.s_eval, jkeys.pk[0], jkeys.pk[1],
        np.asarray(jkeys.relin.kb), np.asarray(jkeys.relin.ka),
        rot={g: (np.asarray(k.kb), np.asarray(k.ka)) for g, k in jkeys.rot.items()})
    return jctx, jkeys, ctx, keys


def test_reference_writes_port_reads(both, tmp_path):
    jctx, jkeys, ctx, keys = both
    # the reference's cc.json cannot carry this chain (see above): the port's does
    jser.save_eval_keys(str(tmp_path / "keys.npz"), jkeys)
    x = np.arange(16) / 16.0
    jct = jkeys.encrypt(x, seed=3)
    jser.save_ciphertext(str(tmp_path / "ct.npz"), jct)
    got = tser.load_eval_keys(str(tmp_path / "keys.npz"), ctx)
    assert got.s_eval is None and set(got.rot) == set(jkeys.rot)
    assert 2 * 256 - 1 in got.rot                             # the conjugation key
    np.testing.assert_array_equal(got.pk[0], jkeys.pk[0])
    np.testing.assert_array_equal(got.pk[1], jkeys.pk[1])
    _eq(got.relin.kb, jkeys.relin.kb)
    _eq(got.relin.ka, jkeys.relin.ka)
    for g, k in jkeys.rot.items():
        _eq(got.rot[g].kb, k.kb)
        _eq(got.rot[g].ka, k.ka)
    ct = tser.load_ciphertext(str(tmp_path / "ct.npz"), "cpu")
    _eq(ct.data, jct.data)
    assert (ct.level, ct.sdeg, ct.slots) == (jct.level, jct.sdeg, jct.slots)
    # the loaded keys compute what the reference's compute, bit for bit
    out = Evaluator(ctx, got).conjugate(Evaluator(ctx, got).rotate(ct, -2))
    jev = JEvaluator(jctx, jkeys)
    _eq(out.data, jev.conjugate(jev.rotate(jct, -2)).data)


def test_port_writes_reference_reads(both, tmp_path):
    jctx, jkeys, ctx, keys = both
    tser.save_context(str(tmp_path / "cc.json"), ctx)
    tser.save_eval_keys(str(tmp_path / "keys.npz"), keys)
    ct = keys.encrypt(np.arange(16) / 16.0, seed=3)
    tser.save_ciphertext(str(tmp_path / "ct.npz"), ct)
    jctx2 = jser.load_context(str(tmp_path / "cc.json"))
    assert jctx2.params == jctx.params and jctx2.q_primes == ctx.q_primes
    got = jser.load_eval_keys(str(tmp_path / "keys.npz"), jctx2)
    assert got.s_eval is None and set(got.rot) == set(keys.rot)
    np.testing.assert_array_equal(got.pk[0], keys.pk[0])
    _eq(keys.relin.kb, got.relin.kb)
    for g, k in keys.rot.items():
        _eq(k.kb, got.rot[g].kb)
        _eq(k.ka, got.rot[g].ka)
    jct = jser.load_ciphertext(str(tmp_path / "ct.npz"))
    _eq(ct.data, jct.data)
    assert (jct.level, jct.sdeg, jct.slots) == (ct.level, ct.sdeg, ct.slots)
    assert np.asarray(jct.data).dtype == np.uint32
    np.testing.assert_array_equal(jkeys.decrypt(jct), keys.decrypt(ct))


def test_port_reads_compressed_and_uncompressed(both, tmp_path):
    """`np.load` reads either kind: the reference compresses, the port does not."""
    import zipfile

    jctx, jkeys, ctx, keys = both
    jser.save_eval_keys(str(tmp_path / "j.npz"), jkeys)
    tser.save_eval_keys(str(tmp_path / "t.npz"), keys)
    kinds = {n: {i.compress_type for i in zipfile.ZipFile(tmp_path / n).infolist()}
             for n in ("j.npz", "t.npz")}
    assert kinds == {"j.npz": {zipfile.ZIP_DEFLATED}, "t.npz": {zipfile.ZIP_STORED}}
    a = tser.load_eval_keys(str(tmp_path / "j.npz"), ctx)
    b = tser.load_eval_keys(str(tmp_path / "t.npz"), ctx)
    for g in a.rot:
        assert torch.equal(a.rot[g].kb, b.rot[g].kb) and torch.equal(a.rot[g].ka, b.rot[g].ka)
    # save_eval_keys names its file as np.savez does
    tser.save_eval_keys(str(tmp_path / "bare"), keys)
    assert (tmp_path / "bare.npz").exists()
