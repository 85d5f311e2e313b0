"""The benchmark's calls into the program: its context, its keys from a given secret, its encryption.

Everything here goes through `fhe_sorting_tpu_torch`'s public classes.  The
secret is the benchmark's: drawn from the seed by `traffic.secret` and
handed to the program, which derives its evaluation-domain form, the public
key and, on the device, the evaluation keys.
"""

from __future__ import annotations

import numpy as np

# the configuration keys that are the program's `CkksParams` fields
PARAM_KEYS = ("ring_n", "mult_depth", "scale_bits", "comp", "base_limbs", "dnum",
              "special_bits", "sigma", "ntt_impl", "first_mod_bits")


def context(params: dict, device):
    from fhe_sorting_tpu_torch.core.context import CkksParams, Context

    return Context(CkksParams(**{k: params[k] for k in PARAM_KEYS if k in params}),
                   device=device)


def keys(ctx, s: np.ndarray, rng: np.random.Generator, rotation_steps,
         conjugation_key: bool = False):
    """The program's key set for the secret coefficients `s`: its residues
    in the program's evaluation domain and the public key on the host, then
    the relinearisation key, the rotation keys of `rotation_steps` and, with
    `conjugation_key`, the conjugation key on the device, their randomness
    drawn from `rng` in that order (so the others' bits do not depend on
    whether the conjugation key is asked for)."""
    from fhe_sorting_tpu_torch.core.encoding import coeffs_to_residues
    from fhe_sorting_tpu_torch.core.keys import Keys, _host_ntt_all

    n = ctx.params.ring_n
    s = np.asarray(s, dtype=np.int64)
    s_eval = _host_ntt_all(ctx, coeffs_to_residues(s, ctx.all_primes))
    e = np.rint(rng.normal(0, ctx.params.sigma, size=n)).astype(np.int64)
    e_eval = _host_ntt_all(ctx, coeffs_to_residues(e, ctx.q_primes))
    a = np.stack([rng.integers(0, p, size=n, dtype=np.uint64) for p in ctx.q_primes])
    b = np.zeros_like(a)
    for i, p in enumerate(ctx.q_primes):
        P = np.uint64(p)
        b[i] = ((P - a[i]) * s_eval[i] + e_eval[i]) % P
    out = Keys(ctx=ctx, s_coeffs=s.astype(np.int8), s_eval=s_eval, pk=(b, a))
    out.gen_relin_key(rng)
    out.gen_rotation_keys(rotation_steps, seed=int(rng.integers(0, 2**63)))
    if conjugation_key:
        out.gen_conj_key(seed=int(rng.integers(0, 2**63)))
    return out


def encrypt(keys, values: np.ndarray, slots: int, seed: int):
    """A fresh public-key encryption of `values` in the first slots of a
    `slots`-slot ciphertext (zeros after them)."""
    pad = np.zeros(slots)
    pad[: len(values)] = values
    return keys.encrypt(pad, slots=slots, seed=seed)

