"""Key generation, encryption and decryption.

Port of `fhe_sorting_tpu/core/keys.py`.  The secret, the public key,
encrypt and decrypt run on the host with numpy exactly as in the reference,
so the same seed gives the same bits.  Key-switch keys are built on
`ctx.device`: their uniform `a` comes from a `torch.Generator` seeded from
the numpy stream (so they differ from the reference's `jax.random` keys),
the noise from the numpy stream as in the reference.

Hybrid key-switch keys (dnum digits, special primes P): for digit j,
    ksk_b[j] = -a_j * s + e_j + P * (Q/D_j) * [(Q/D_j)^{-1}]_{D_j} * s'
over every prime of Q*P, with s' = s^2 (relinearisation) or sigma_g(s).

`Keys.from_numpy` builds keys from arrays (for example a JAX package key
set, converted with `np.asarray`) so both packages can compute on identical
keys and be compared bit for bit.

A key set with `rows` is one limb rank's view (`parallel/mesh.LimbLayout.
key_rows`): every key-switch key holds only those rows of its Lq+K, in that
order, taken before anything reaches the device (`from_numpy` selects them
on the host; generation makes no other row).  Generation draws each
row's uniform part from a generator of its own, seeded by the key's seed
and the row, whether the key set holds every row or some: so ranks that
split the rows of one stream hold rows of the same keys as a whole key
set, whatever the split.  A `Keys` with `s_coeffs=s_eval=None` is
the server's secret-free key set (`core/serialize.load_eval_keys` builds
one): it encrypts and evaluates, and raises `SecretKeyMissing` on anything
that needs the secret.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import ntt as nttm
from .cipher import Ciphertext
from .context import Context
from .encoding import coeffs_to_residues, crt_to_float_centered, decode_coeffs, encode_coeffs
from .modmath import add_mod, mulmod, neg_mod


def _host_ntt_all(ctx: Context, res: np.ndarray) -> np.ndarray:
    out = np.zeros_like(res)
    for k in range(res.shape[0]):
        out[k] = nttm.host_ntt(res[k], ctx._host_psi_rev[k], ctx.all_primes[k])
    return out


def _host_intt_all(ctx: Context, res: np.ndarray) -> np.ndarray:
    out = np.zeros_like(res)
    for k in range(res.shape[0]):
        out[k] = nttm.host_intt(res[k], ctx._host_ipsi_rev[k],
                                int(ctx._host_ninv[k]), ctx.all_primes[k])
    return out


class SecretKeyMissing(RuntimeError):
    """An operation that needs the secret key on a secret-free key set."""


@dataclass
class KeySwitchKey:
    kb: torch.Tensor  # [dnum, Lq+K, n] int64 eval domain
    ka: torch.Tensor


@dataclass
class Keys:
    """Secret + public + evaluation keys.  The secret parts stay on the
    host; evaluation keys live on `ctx.device`."""

    ctx: Context
    s_coeffs: np.ndarray | None     # [n] int8 ternary (None: server side)
    s_eval: np.ndarray | None       # [Lq+K, n] u64 eval residues (host)
    pk: tuple                       # (b, a) [Lq, n] u64 eval (host)
    relin: KeySwitchKey | None = None
    rot: dict = field(default_factory=dict)    # galois element -> KeySwitchKey
    rows: tuple | None = None       # the rows of Lq+K held (None: all)

    # -- generation -------------------------------------------------------

    @classmethod
    def generate(cls, ctx: Context, seed: int = 0, rows: tuple | None = None) -> "Keys":
        """`rows`: hold only those rows of every key-switch key (the module
        docstring)."""
        rng = np.random.default_rng(seed)
        n = ctx.params.ring_n
        all_p = ctx.all_primes
        h = ctx.params.secret_hamming
        if h is None:
            s = rng.integers(-1, 2, size=n).astype(np.int64)  # uniform ternary
        else:
            # sparse ternary secret (bounds the q0*I term in bootstrapping)
            s = np.zeros(n, dtype=np.int64)
            pos = rng.choice(n, size=h, replace=False)
            s[pos] = rng.choice([-1, 1], size=h)
        s_eval = _host_ntt_all(ctx, coeffs_to_residues(s, all_p))

        e = np.rint(rng.normal(0, ctx.params.sigma, size=n)).astype(np.int64)
        e_eval = _host_ntt_all(ctx, coeffs_to_residues(e, ctx.q_primes))
        a = np.stack([rng.integers(0, p, size=n, dtype=np.uint64)
                      for p in ctx.q_primes])
        b = np.zeros_like(a)
        for i, p in enumerate(ctx.q_primes):
            P = np.uint64(p)
            b[i] = ((P - a[i]) * s_eval[i] + e_eval[i]) % P
        keys = cls(ctx=ctx, s_coeffs=s.astype(np.int8), s_eval=s_eval, pk=(b, a),
                   rows=None if rows is None else tuple(rows))
        keys.gen_relin_key(rng)
        return keys

    @classmethod
    def from_numpy(cls, ctx: Context, s_coeffs, s_eval, pk_b, pk_a,
                   relin_kb, relin_ka, rot=None, conj=None,
                   rows: tuple | None = None) -> "Keys":
        """Keys from numpy arrays; `rot` maps galois element -> (kb, ka),
        `conj` is the conjugation key's (kb, ka).  `s_coeffs` and `s_eval`
        may both be None: the key set then holds no secret.  `rows`: only
        those rows of every key-switch key [dnum, Lq+K, n] are uploaded."""
        sel = slice(None) if rows is None else list(rows)

        def dev(k):
            return ctx.tensor(np.asarray(k)[:, sel])

        assert (s_coeffs is None) == (s_eval is None), "secret: both parts or neither"
        keys = cls(
            ctx=ctx,
            s_coeffs=None if s_coeffs is None else np.asarray(s_coeffs, dtype=np.int8),
            s_eval=None if s_eval is None else np.asarray(s_eval, dtype=np.uint64),
            pk=(np.asarray(pk_b, dtype=np.uint64), np.asarray(pk_a, dtype=np.uint64)),
            relin=KeySwitchKey(dev(relin_kb), dev(relin_ka)),
            rot={int(g): KeySwitchKey(dev(kb), dev(ka))
                 for g, (kb, ka) in (rot or {}).items()},
            rows=None if rows is None else tuple(rows),
        )
        if conj is not None:
            keys.rot[2 * ctx.params.ring_n - 1] = KeySwitchKey(dev(conj[0]), dev(conj[1]))
        return keys

    def _gadget_residues(self) -> np.ndarray:
        """Per-digit hybrid gadget residues [dnum, Lq+K] (host bigints)."""
        ctx = self.ctx
        Q = 1
        for p in ctx.q_primes:
            Q *= p
        out = []
        for lo, hi in ctx.digit_layout(0):
            D = 1
            for p in ctx.q_primes[lo:hi]:
                D *= p
            QhatD = Q // D
            g_big = ctx.P * QhatD * pow(QhatD, -1, D)
            out.append([g_big % p for p in ctx.all_primes])
        out = np.array(out, dtype=np.int64)
        return out if self.rows is None else out[:, list(self.rows)]

    def _need_secret(self, what: str):
        if self.s_eval is None:
            raise SecretKeyMissing(f"{what} needs the secret key; this key set holds none")

    @property
    def _s_dev(self) -> torch.Tensor:
        """The secret's residues on the held rows, on the device."""
        self._need_secret("key generation")
        if getattr(self, "_s_dev_t", None) is None:
            held = self.s_eval if self.rows is None else self.s_eval[list(self.rows)]
            self._s_dev_t = self.ctx.tensor(held)
        return self._s_dev_t

    @property
    def _row_limbs(self) -> torch.Tensor | None:
        """The held rows as an index tensor into the chain (None: all)."""
        if self.rows is None:
            return None
        if getattr(self, "_row_limbs_t", None) is None:
            self._row_limbs_t = self.ctx.tensor(self.rows)
        return self._row_limbs_t

    @property
    def _row_primes(self) -> torch.Tensor:
        """The primes [rows, 1] of the held rows."""
        p = self.ctx.pc.p
        return p if self.rows is None else p[self._row_limbs]

    def key_bytes(self) -> int:
        """Device bytes of the key-switch keys held (relin and rotations)."""
        held = [k for k in (self.relin, *self.rot.values()) if k is not None]
        return sum(t.numel() * t.element_size() for k in held for t in (k.kb, k.ka))

    def _ksk_draws(self, rng) -> tuple:
        """What one key-switch key draws from the numpy stream `rng`: its
        error [dnum, n] and the seed of its uniform part.  A caller that
        skips a key of a stream (`parallel/direct_sharded.gen_offset_keys`)
        draws these alone, so the keys after it stay the same."""
        dnum = len(self.ctx.digit_layout(0))
        n = self.ctx.params.ring_n
        e = np.rint(rng.normal(0, self.ctx.params.sigma, size=(dnum, n))).astype(np.int64)
        return e, int(rng.integers(0, 2**63))

    def _uniform(self, seed: int, dnum: int) -> torch.Tensor:
        """The uniform draws [dnum, rows, n] of a key's held rows before
        their reduction, row by row from a generator seeded by `seed` and
        the row."""
        ctx = self.ctx
        n = ctx.params.ring_n
        gen = torch.Generator(device=ctx.device)

        def draw(row):
            gen.manual_seed((seed + row * 0x9E3779B97F4A7C15) % (1 << 63))
            return torch.randint(0, 1 << 62, (dnum, n), generator=gen, device=ctx.device,
                                 dtype=torch.int64)

        rows = range(ctx.num_q + ctx.num_sp) if self.rows is None else self.rows
        return torch.stack([draw(k) for k in rows], dim=1)

    def _gen_ksk(self, target: torch.Tensor, rng) -> KeySwitchKey:
        """target: s' residues [rows, n] eval domain on the device (every
        row of Lq+K, or the key set's `rows`).

        kb[j] = -a_j * s + e_j + g_j * s' over the held rows of the Q*P
        primes; the uniform a_j comes from a device generator seeded from
        the numpy stream (`_uniform`)."""
        ctx = self.ctx
        gres = ctx.tensor(self._gadget_residues())            # [dnum, rows]
        dnum = gres.shape[0]
        e, seed = self._ksk_draws(rng)
        p = self._row_primes                                  # [rows, 1]
        e_res = torch.remainder(ctx.tensor(e)[:, None, :], p)  # [dnum, rows, n]
        e_eval = nttm.ntt(e_res, ctx.tables, self._row_limbs)
        # 2^62 mod p / 2^62 < 2^-31: statistically uniform mod p
        a = torch.remainder(self._uniform(seed, dnum), p)
        kb = add_mod(mulmod(neg_mod(a, p), self._s_dev, p), e_eval, p)
        kb = add_mod(kb, mulmod(gres[:, :, None], target, p), p)
        return KeySwitchKey(kb=kb, ka=a)

    def gen_relin_key(self, rng=None):
        self.ctx.thawed("a key generation")
        s_dev = self._s_dev
        self.relin = self._gen_ksk(mulmod(s_dev, s_dev, self._row_primes),
                                   rng or np.random.default_rng(1))

    def gen_rotation_keys(self, steps, seed: int | None = None):
        """Keys for the given slot-rotation steps (one at a time is fine:
        the lazy key pool of `ops/rotation.py` does that), drawn from ONE
        persistent generator across calls (a fixed seed per call would reuse
        `a` for different galois targets and leak the secret).  An explicit
        `seed` reseeds the stream (tests only)."""
        self.ctx.thawed("a key generation")
        if seed is not None or getattr(self, "_rot_rng", None) is None:
            self._rot_rng = np.random.default_rng(2 if seed is None else seed)
        for r in steps:
            g = self.ctx.galois_element_rot(r)
            if g in self.rot or g == 1:
                continue
            s_g = self._s_dev[:, self.ctx.galois_perm(g)]
            self.rot[g] = self._gen_ksk(s_g, self._rot_rng)

    def gen_conj_key(self, seed: int = 3):
        self.ctx.thawed("a key generation")
        g = 2 * self.ctx.params.ring_n - 1
        if g not in self.rot:
            s_g = self._s_dev[:, self.ctx.galois_perm(g)]
            self.rot[g] = self._gen_ksk(s_g, np.random.default_rng(seed))

    def available_rotations(self):
        return set(self.rot.keys())

    # -- encrypt / decrypt ------------------------------------------------

    def encrypt(self, values, level: int = 0, slots: int | None = None,
                seed=None) -> Ciphertext:
        ctx = self.ctx
        n = ctx.params.ring_n
        rng = np.random.default_rng(seed)
        s = slots if slots is not None else len(values)
        coeffs = encode_coeffs(values, n, ctx.scale(level, 1), slots=s)
        qs = ctx.q_primes[: ctx.limbs_at(level)]
        m_eval = _host_ntt_all(ctx, coeffs_to_residues(coeffs, qs))
        v = rng.integers(-1, 2, size=n).astype(np.int64)
        e0 = np.rint(rng.normal(0, ctx.params.sigma, size=n)).astype(np.int64)
        e1 = np.rint(rng.normal(0, ctx.params.sigma, size=n)).astype(np.int64)
        v_eval = _host_ntt_all(ctx, coeffs_to_residues(v, qs))
        e0_eval = _host_ntt_all(ctx, coeffs_to_residues(e0, qs))
        e1_eval = _host_ntt_all(ctx, coeffs_to_residues(e1, qs))
        pkb, pka = self.pk
        c = np.zeros((2, len(qs), n), dtype=np.uint64)
        for i, p in enumerate(qs):
            P64 = np.uint64(p)
            c[0, i] = (pkb[i] * v_eval[i] + e0_eval[i] + m_eval[i]) % P64
            c[1, i] = (pka[i] * v_eval[i] + e1_eval[i]) % P64
        return Ciphertext.from_numpy(c, level, 1, s, ctx.device)

    def decrypt(self, ct: Ciphertext, num_values: int | None = None) -> np.ndarray:
        return self.decrypt_complex(ct, num_values).real

    def decrypt_complex(self, ct: Ciphertext,
                        num_values: int | None = None) -> np.ndarray:
        self._need_secret("decrypt")
        ctx = self.ctx
        Ll = ct.num_limbs
        qs = ctx.q_primes[:Ll]
        data = ct.data.cpu().numpy().astype(np.uint64)
        m_eval = np.zeros((Ll, ctx.params.ring_n), dtype=np.uint64)
        for i, p in enumerate(qs):
            P64 = np.uint64(p)
            m_eval[i] = (data[0, i] + data[1, i] * self.s_eval[i]) % P64
        vals = crt_to_float_centered(_host_intt_all(ctx, m_eval), qs)
        out = decode_coeffs(vals, ctx.params.ring_n, ctx.scale(ct.level, ct.sdeg), ct.slots)
        return out[:num_values] if num_values is not None else out
