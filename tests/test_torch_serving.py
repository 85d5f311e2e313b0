"""The port's serving path on files: `fhe_sorting_tpu_torch.serving.sort_server`
through its `main`, on the CPU (`--device cpu`, the plain NTTs), at ring 512.

The same input files served by the JAX package's server and by the port's
must give bit-equal `out.npz` `data` (tolerance 0); decrypted sorts are held
to max error < 0.01 against `np.sort`, the reference's own bound.  A failure
(an unported algorithm, a missing rotation key, no CUDA device) must end the
server with an error and leave no output file."""

import os

import numpy as np
import pytest
import torch

from fhe_sorting_tpu.core import serialize as jser
from fhe_sorting_tpu.core.context import CkksParams as JParams
from fhe_sorting_tpu.core.context import Context as JContext
from fhe_sorting_tpu.core.keys import Keys as JKeys
from fhe_sorting_tpu.models.direct_sort import rotation_indices_direct_sort as j_indices
from fhe_sorting_tpu.utils.depth_meter import measure_direct_sort_depth as j_depth
from fhe_sorting_tpu_torch.core.context import CkksParams, Context
from fhe_sorting_tpu_torch.core.facade import DebugEncryption, Encryption, print_pt
from fhe_sorting_tpu_torch.core.keys import Keys
from fhe_sorting_tpu_torch.core.serialize import (
    load_ciphertext, save_ciphertext, save_context, save_eval_keys)
from fhe_sorting_tpu_torch.models.bitonic import rotation_indices_bitonic
from fhe_sorting_tpu_torch.models.direct_sort import rotation_indices_direct_sort
from fhe_sorting_tpu_torch.models.mehp24.utils import rotation_indices_mehp24
from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig
from fhe_sorting_tpu_torch.serving.sort_server import main as server_main
from fhe_sorting_tpu_torch.utils.depth_meter import measure_direct_sort_depth

torch.set_num_threads(2)

N, RING = 8, 512
SIGN = ["--sign_n", "3", "--dg", "2", "--df", "2"]


def _argv(d, n, algo, *extra):
    return ["--cc", str(d / "cc.json"), "--keys", str(d / "keys.npz"),
            "--input", str(d / "in.npz"), "--output", str(d / "out.npz"),
            "--n", str(n), "--algo", algo, "--device", "cpu", *extra]


def _client(d, params, steps, x, slots=None):
    """Writes cc.json, keys.npz, in.npz; returns the client's keys."""
    ctx = Context(CkksParams(**params), device="cpu")
    keys = Keys.generate(ctx, seed=0)
    keys.gen_rotation_keys(sorted(steps))
    save_context(str(d / "cc.json"), ctx)
    save_eval_keys(str(d / "keys.npz"), keys)
    save_ciphertext(str(d / "in.npz"), keys.encrypt(x, slots=slots, seed=1))
    return keys


@pytest.fixture(scope="module")
def direct_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("direct")
    depth = measure_direct_sort_depth(N, RING, SignConfig(CompositeSignConfig(3, 2, 2)))["mult_depth"]
    x = np.random.default_rng(13).permutation(N) / N + 0.5 / N
    keys = _client(d, dict(ring_n=RING, mult_depth=depth, ntt_impl="butterfly"),
                   rotation_indices_direct_sort(N, RING), x)
    return d, keys, x


def test_server_cli_end_to_end(direct_files, capsys):
    """Client writes context, evaluation keys and the encrypted input; the
    server (no secret key) sorts through `main`; the client decrypts."""
    d, keys, x = direct_files
    server_main(_argv(d, N, "direct", *SIGN))
    assert f"sorted N={N} with direct" in capsys.readouterr().err
    got = keys.decrypt(load_ciphertext(str(d / "out.npz"), "cpu"), N)
    assert np.abs(got - np.sort(x)).max() < 0.01


def test_server_registry_default_sign_cfg(direct_files):
    """Without --sign_n/--dg/--df the registry's per-N choice is used: (3,3,2)
    at N=8 needs more depth than this (3,2,2) context has, and the server
    says so instead of writing an output."""
    d, keys, x = direct_files
    os.remove(d / "out.npz") if (d / "out.npz").exists() else None
    with pytest.raises(RuntimeError, match="depth exhausted"):
        server_main(_argv(d, N, "direct"))
    assert not (d / "out.npz").exists()


def test_both_servers_give_equal_output(tmp_path):
    """Files written by the JAX package, served by its server and by the
    port's: `out.npz` `data` bit-equal."""
    from serving.sort_server import main as j_server_main

    from fhe_sorting_tpu.ops.sign import CompositeSignConfig as JCfg
    from fhe_sorting_tpu.ops.sign import SignConfig as JSign

    depth = j_depth(N, RING, JSign(JCfg(3, 2, 2)))["mult_depth"]
    jctx = JContext(JParams(ring_n=RING, mult_depth=depth))
    jkeys = JKeys.generate(jctx, seed=0)
    jkeys.gen_rotation_keys(sorted(j_indices(N, RING)))
    jser.save_context(str(tmp_path / "cc.json"), jctx)
    jser.save_eval_keys(str(tmp_path / "keys.npz"), jkeys)
    x = np.random.default_rng(13).permutation(N) / N + 0.5 / N
    jser.save_ciphertext(str(tmp_path / "in.npz"), jkeys.encrypt(x, seed=1))

    argv = _argv(tmp_path, N, "direct", *SIGN)
    server_main(argv)
    with np.load(tmp_path / "out.npz") as z:
        t_data, t_meta = z["data"], z["meta"]
    os.remove(tmp_path / "out.npz")
    j_server_main([a for a in argv if a not in ("--device", "cpu")])
    with np.load(tmp_path / "out.npz") as z:
        j_data, j_meta = z["data"], z["meta"]
    assert t_data.dtype == j_data.dtype == np.uint32
    np.testing.assert_array_equal(t_meta, j_meta)
    np.testing.assert_array_equal(t_data, j_data)
    got = jkeys.decrypt(jser.load_ciphertext(str(tmp_path / "out.npz")), N)
    assert np.abs(got - np.sort(x)).max() < 0.01


def test_server_bitonic(tmp_path):
    n = 2
    x = np.array([0.8, 0.3])
    keys = _client(tmp_path, dict(ring_n=RING, mult_depth=16, ntt_impl="butterfly"),
                   rotation_indices_bitonic(n), x, slots=n)
    server_main(_argv(tmp_path, n, "bitonic", *SIGN))
    got = keys.decrypt(load_ciphertext(str(tmp_path / "out.npz"), "cpu"), n)
    assert np.abs(got - np.sort(x)).max() < 0.01


def test_server_mehp24(tmp_path):
    n = 4
    x = np.array([0.55, 0.05, 0.8, 0.3])
    padded = np.zeros(n * n)
    padded[:n] = x
    keys = _client(tmp_path, dict(ring_n=RING, mult_depth=38, ntt_impl="butterfly"),
                   rotation_indices_mehp24(n), padded, slots=n * n)
    server_main(_argv(tmp_path, n, "mehp24", *SIGN))
    got = keys.decrypt(load_ciphertext(str(tmp_path / "out.npz"), "cpu"), n)
    assert np.abs(got - np.sort(x)).max() < 0.01


@pytest.mark.parametrize("algo", ["kway", "quick"])
def test_unported_algo_exits_nonzero(direct_files, algo, capsys):
    d, _, _ = direct_files
    before = (d / "out.npz").exists()
    with pytest.raises(SystemExit) as exc:
        server_main(_argv(d, N, algo, *SIGN))
    assert exc.value.code not in (0, None)
    err = capsys.readouterr().err
    if algo == "kway":
        assert "ROADMAP" in err and "not ported" in err
    assert (d / "out.npz").exists() == before


def test_missing_rotation_key_fails_and_writes_nothing(tmp_path):
    depth = measure_direct_sort_depth(N, RING, SignConfig(CompositeSignConfig(3, 2, 2)))["mult_depth"]
    steps = sorted(rotation_indices_direct_sort(N, RING))[-1:]        # all keys but one missing
    x = np.random.default_rng(13).permutation(N) / N + 0.5 / N
    _client(tmp_path, dict(ring_n=RING, mult_depth=depth, ntt_impl="butterfly"), steps, x)
    with pytest.raises(AssertionError, match="missing rotation key"):
        server_main(_argv(tmp_path, N, "direct", *SIGN))
    assert not (tmp_path / "out.npz").exists()


def test_default_device_raises_without_cuda(direct_files):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    d, _, _ = direct_files
    argv = [a for a in _argv(d, N, "direct", *SIGN) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        server_main(argv)


def test_server_module_runs_as_a_process(direct_files):
    """`python -m fhe_sorting_tpu_torch.serving.sort_server`: exit code 0 and
    an output file on success, non-zero and none on an unported algorithm."""
    import subprocess
    import sys

    d, keys, x = direct_files
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = d / "proc_out.npz"
    argv = [a if a != str(d / "out.npz") else str(out) for a in _argv(d, N, "direct", *SIGN)]
    cmd = [sys.executable, "-m", "fhe_sorting_tpu_torch.serving.sort_server"]
    bad = subprocess.run(cmd + [a if a != "direct" else "kway" for a in argv],
                         env=env, cwd=root, capture_output=True, text=True)
    assert bad.returncode != 0 and not out.exists()
    ok = subprocess.run(cmd + argv, env=env, cwd=root, capture_output=True, text=True)
    assert ok.returncode == 0, ok.stderr
    got = keys.decrypt(load_ciphertext(str(out), "cpu"), N)
    assert np.abs(got - np.sort(x)).max() < 0.01


def test_facade(capsys):
    ctx = Context(CkksParams(ring_n=256, mult_depth=4), device="cpu")
    keys = Keys.generate(ctx, seed=1)
    enc = Encryption(keys)
    dbg = DebugEncryption(keys)
    x = np.array([0.1, 0.2, 0.3, 0.4])
    ct = enc.encrypt_input(x)
    got = dbg.get_decrypt(ct, 4)
    np.testing.assert_allclose(got, x, atol=5e-5)
    print_pt(enc, ct)  # no-op: not decrypt-capable
    assert capsys.readouterr().out == ""
    print_pt(dbg, ct, 4)
    assert "level" in capsys.readouterr().out
    with pytest.raises(AssertionError, match="too long"):
        enc.encrypt_input(np.zeros(129))
