"""Serialization of contexts, keys and ciphertexts (the serving boundary).

Port of `fhe_sorting_tpu/core/serialize.py`.  The server process loads a
crypto context, public and evaluation keys and an input ciphertext from
files, evaluates, and writes the output ciphertext; it never sees a secret.

The format is the reference's, so files cross between the two packages in
both directions: `cc.json` holds the parameters, and numpy archives hold the
keys (`pk_b`, `pk_a`, `relin_kb`, `relin_ka`, `rot_gs`, `rot_{g}_kb`,
`rot_{g}_ka`) and a ciphertext (`data`, `meta = [level, sdeg, slots]`).
Residues are uint32 in a file whatever the device holds (int64): they are
converted at the boundary, and a residue outside [0, 2^32) is refused.

Two differences from the reference, both on purpose:

  * `save_context` writes EVERY field of `CkksParams`.  The reference writes
    7 of its 12 and drops `comp`, `secret_hamming`, `first_mod_bits`,
    `ntt_impl` and `ksk_shoup`, so a composite-scaling chain
    (`scale_bits=56, comp=2`) written by it reloads as `comp=1` with other
    primes, or trips the prime-size assertion.  `load_context` fills a field
    the file lacks with the dataclass default, so the reference's files
    still load (and mean what the reference's loader takes them to mean).
  * archives are written with `np.savez`, not `np.savez_compressed`: the
    key planes are uniformly random residues below 2^30 or 2^31 in 32 bits,
    which zlib cannot shrink by more than the unused top bit or two and
    spends minutes on at ring 2^17.  `np.load` reads either kind, so the
    reference's compressed files load here and these load there.

`load_eval_keys` moves one key plane at a time to the device: the host never
holds more than one `[dnum, Lq+K, n]` array of the archive.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .cipher import Ciphertext
from .context import CkksParams, Context
from .keys import Keys, KeySwitchKey


def _to_u32(t: torch.Tensor) -> np.ndarray:
    """Device residues -> uint32 for a file; refuses what does not fit."""
    a = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    if a.size and (int(a.min()) < 0 or int(a.max()) >= 1 << 32):
        raise ValueError(
            f"residue outside [0, 2^32) (min {int(a.min())}, max {int(a.max())}): "
            "not a canonical residue of a prime below 2^32")
    return a.astype(np.uint32)


def save_context(path: str, ctx: Context):
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(ctx.params), f)


def load_context(path: str, device=None) -> Context:
    """`device=None` is the first CUDA card, as for `Context`."""
    with open(path) as f:
        kw = json.load(f)
    known = {f.name for f in dataclasses.fields(CkksParams)}
    unknown = set(kw) - known
    if unknown:
        raise ValueError(f"{path}: unknown context fields {sorted(unknown)}")
    return Context(CkksParams(**kw), device=device)


def save_ciphertext(path: str, ct: Ciphertext):
    np.savez(path, data=_to_u32(ct.data),
             meta=np.array([ct.level, ct.sdeg, ct.slots], dtype=np.int64))


def load_ciphertext(path: str, device=None) -> Ciphertext:
    with np.load(path) as z:
        level, sdeg, slots = (int(v) for v in z["meta"])
        return Ciphertext.from_numpy(z["data"], level, sdeg, slots, device)


def save_eval_keys(path: str, keys: Keys):
    """Public and evaluation keys only, never the secret key.  One key's
    planes are on the host at a time (the archive is written entry by
    entry)."""
    import zipfile

    if keys.rows is not None:
        raise ValueError("these are one limb rank's rows of the keys: save a whole key set")

    def entries():
        yield "pk_b", lambda: _to_u32(keys.pk[0])
        yield "pk_a", lambda: _to_u32(keys.pk[1])
        yield "relin_kb", lambda: _to_u32(keys.relin.kb)
        yield "relin_ka", lambda: _to_u32(keys.relin.ka)
        yield "rot_gs", lambda: np.array(sorted(keys.rot.keys()), dtype=np.int64)
        for g, ksk in keys.rot.items():
            yield f"rot_{g}_kb", lambda k=ksk: _to_u32(k.kb)
            yield f"rot_{g}_ka", lambda k=ksk: _to_u32(k.ka)

    if not path.endswith(".npz"):
        path += ".npz"                      # as np.savez names its file
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, make in entries():
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, make(), allow_pickle=False)


def load_eval_keys(path: str, ctx: Context) -> Keys:
    """A server-side (secret-free) `Keys` on `ctx.device`, loaded key by
    key."""
    with np.load(path) as z:
        def ksk(name):
            return KeySwitchKey(ctx.tensor(z[f"{name}_kb"]), ctx.tensor(z[f"{name}_ka"]))

        keys = Keys(ctx=ctx, s_coeffs=None, s_eval=None,
                    pk=(z["pk_b"].astype(np.uint64), z["pk_a"].astype(np.uint64)),
                    relin=ksk("relin"))
        for g in z["rot_gs"]:
            keys.rot[int(g)] = ksk(f"rot_{int(g)}")
    return keys
