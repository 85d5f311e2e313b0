"""Homomorphic evaluation ops over int64 limb planes (the main-path surface).

Port of `fhe_sorting_tpu/core/evaluator.py`: add/sub/negate, ct*pt, ct*ct
with relinearisation, rescale, level alignment, rotations and conjugation
by Galois gather (direct, and hoisted over one shared ModUp), the on-device
plaintext roll of `mult_plain_at` and the batched linear combination
`combo`.  Every op runs eagerly on `ctx.device` and returns the
same canonical residues as the reference.

The automorphism is a gather by default.  `FHE_AFFINE_AUTO` opts into the
gather-free form of `core/auto_affine.py` by the JAX package's rule: "1" on
a four-step (K1) context, "force" on any.  Both give the same residues.

Key switching is hybrid: ModUp (INTT, CRT base extension per digit as an
exact modular matmul, NTT of every digit in one batched call), the inner
product with the key, then ModDown (division by P).  Every NTT goes through
`core/ntt.py`, which on a GPU launches the CUDA kernel of the context's
tables: K1 (four-step) or K2 (butterfly).  Limb subsets are index tensors cached on the context, so no table is
sliced or copied per op.

Everything an op uploads is memoised on the device: encoded plaintexts (an
LRU bounded by bytes), scalar residues by (integer, limbs), and `combo`'s
coefficient and constant residues by content.  So once a call has run, the
same call uploads nothing, and `frozen()` can hold it to that while a CUDA
graph captures it (`parallel/whole_graph.py`).
"""

from __future__ import annotations

import hashlib
import os
import time
from collections import Counter, OrderedDict
from contextlib import contextmanager
from dataclasses import replace

import numpy as np
import torch

from . import ntt as nttm
from .auto_affine import apply_affine
from .cipher import Ciphertext, Plaintext
from .context import Context, FrozenError
from .encoding import coeffs_to_residues, encode_coeffs
from .keys import KeySwitchKey, Keys
from .modmath import add_mod, mulmod, neg_mod, sub_mod
from .ntt_mxu import mod_matmul

# default bound of the encoded-plaintext memo: a full-chain ring-2^17
# plaintext is 68 limbs x 1 MiB of int64, so ~28 of them
_PT_CACHE_BYTES = 2 << 30
# bound of one limb chunk of `combo`'s stacked operand
_COMBO_CHUNK_BYTES = 2 << 30


class Evaluator:
    """Op collection bound to a Context + Keys."""

    def __init__(self, ctx: Context, keys: Keys, pt_cache_bytes: int = _PT_CACHE_BYTES):
        """`pt_cache_bytes` bounds the device bytes of the encoded-plaintext
        memo (a caller that reuses more plaintexts than the default holds,
        such as repeated bootstraps, sizes it from `pt_stats`)."""
        self.ctx = ctx
        self.keys = keys
        self.pt_cache_bytes = pt_cache_bytes
        # memo hits and misses, and host seconds spent encoding the misses
        self.pt_stats = {"hits": 0, "misses": 0, "encode_s": 0.0}
        # logical-op counter for roofline accounting: (op, level) -> count
        self.op_stats: Counter = Counter()
        # encoded-plaintext memo (LRU), bounded by device bytes
        self._pt_cache: OrderedDict = OrderedDict()
        self._pt_cache_used = 0
        # unbounded memos of small uploads: scalar residues [L, 1] by
        # (integer, limbs), combo's residues by content
        self._scalar_memo: dict = {}
        self._combo_memo: dict = {}
        # inside `frozen()`: every memoised tensor and key the ops read
        self._reads: list | None = None
        # the gather-free automorphism, opt-in as in the JAX package
        aff = os.environ.get("FHE_AFFINE_AUTO", "0")
        self.use_affine = aff == "force" or (aff == "1" and ctx.ntt_impl == "mxu")
        if self.use_affine:
            ctx.auto_tables()

    # -- frozen sections ---------------------------------------------------

    @contextmanager
    def frozen(self):
        """A section in which nothing is uploaded, made or freed: a memo miss
        or eviction, a `Context.tensor` upload, a new device cache entry or a
        key generation raises `FrozenError`, naming the operation.  Yields
        the list of every memoised tensor and key-switch key the section's
        ops read (a CUDA graph keeps them alive for its replays)."""
        if self._reads is not None:
            raise FrozenError("frozen sections do not nest")
        self._reads, self.ctx.frozen = [], True
        try:
            yield self._reads
        finally:
            self._reads, self.ctx.frozen = None, False

    def _read(self, obj):
        """Note a memoised object an op reads (inside `frozen()` only)."""
        if self._reads is not None:
            self._reads.append(obj)
        return obj

    # -- helpers -----------------------------------------------------------

    def _ntt(self, x, limbs):
        return nttm.ntt(x, self.ctx.tables, limbs)

    def _intt(self, x, limbs):
        return nttm.intt(x, self.ctx.tables, limbs)

    def _scalar_limbs(self, c: float, level: int, scale: float) -> torch.Tensor:
        m = int(np.rint(np.float64(c) * scale))
        Ll = self.ctx.limbs_at(level)
        hit = self._scalar_memo.get((m, Ll))
        if hit is None:
            hit = self._scalar_memo[(m, Ll)] = self.ctx.tensor(
                [[m % p] for p in self.ctx.q_primes[:Ll]])
        return self._read(hit)

    # The limb-local ops (add, sub, negate, the products and the tensor
    # product, the automorphism's permutation) take their primes from
    # `moduli`, a plaintext's planes from `_pt_planes` and the key switch
    # from `_keyswitch_core`: a limb-parallel evaluator overrides those
    # three and `_scalar_limbs` to run the same ops on its block of limbs.

    def moduli(self, a: Ciphertext) -> torch.Tensor:
        """The primes [L, 1] of a's limb planes."""
        return self.ctx.p_active(a.level)

    def _pt_planes(self, pt: Plaintext) -> torch.Tensor:
        """The plaintext's limb planes that the ops compute on."""
        return pt.data

    # -- plaintext construction --------------------------------------------

    def make_plaintext(self, values, level: int, sdeg: int = 1,
                       slots: int | None = None) -> Plaintext:
        """Encode on the host (the embedding FFT), reduce to residues and NTT
        on the device; memoized by content."""
        ctx = self.ctx
        values = np.asarray(values)
        values = values.astype(np.complex128 if np.iscomplexobj(values) else np.float64)
        s = slots if slots is not None else len(values)
        key = (hashlib.sha1(values.tobytes()).digest(), values.dtype.char, level, sdeg, s)
        hit = self._pt_cache.get(key)
        if hit is not None:
            self._pt_cache.move_to_end(key)
            self.pt_stats["hits"] += 1
            return self._read(hit)
        self.ctx.thawed(f"a plaintext memo miss (level {level}, {s} slots)")
        t0 = time.perf_counter()
        coeffs = encode_coeffs(values, ctx.params.ring_n, ctx.scale(level, sdeg), slots=s)
        if coeffs.dtype == np.int64:
            # centred int64 coefficients: one [n] upload and one remainder per
            # limb on the device, the same canonical residues as the host loop
            res = torch.remainder(ctx.tensor(coeffs)[None, :], ctx.p_active(level))
        else:
            res = ctx.tensor(coeffs_to_residues(coeffs, ctx.q_primes[: ctx.limbs_at(level)]))
        self.pt_stats["misses"] += 1
        self.pt_stats["encode_s"] += time.perf_counter() - t0
        pt = Plaintext(self._ntt(res, ctx.active_limbs(level)), level, sdeg, s)
        nbytes = pt.data.numel() * pt.data.element_size()
        self._pt_cache[key] = pt
        self._pt_cache_used += nbytes
        self._evict()
        return pt

    def _evict(self):
        """Drop the least recently used plaintexts until the memo fits its
        bound (the newest always stays)."""
        while self._pt_cache_used > self.pt_cache_bytes and len(self._pt_cache) > 1:
            self.ctx.thawed("a plaintext memo eviction")
            _, old = self._pt_cache.popitem(last=False)
            self._pt_cache_used -= old.data.numel() * old.data.element_size()

    # -- add / sub / neg ---------------------------------------------------

    def _align_add(self, a: Ciphertext, b: Ciphertext):
        if a.level != b.level:
            if a.level < b.level:
                a = self.adjust_level(a, b.level)
            else:
                b = self.adjust_level(b, a.level)
        if a.sdeg != b.sdeg:
            if a.sdeg == 1:
                a = self._to_sdeg2(a)
            else:
                b = self._to_sdeg2(b)
        return a, b

    def _on_c0(self, a: Ciphertext, fn) -> Ciphertext:
        return a.with_data(torch.stack([fn(a.data[0]), a.data[1]]))

    def add(self, a: Ciphertext, b) -> Ciphertext:
        self.op_stats[("add", a.level)] += 1
        if isinstance(b, Ciphertext):
            a, b = self._align_add(a, b)
            return a.with_data(add_mod(a.data, b.data, self.moduli(a)))
        p = self.moduli(a)
        if isinstance(b, Plaintext):
            assert b.level == a.level and b.sdeg == a.sdeg, "pt/ct mismatch"
            return self._on_c0(a, lambda c0: add_mod(c0, self._pt_planes(b), p))
        sc = self._scalar_limbs(float(b), a.level, self.ctx.scale(a.level, a.sdeg))
        return self._on_c0(a, lambda c0: add_mod(c0, sc, p))

    def sub(self, a: Ciphertext, b) -> Ciphertext:
        self.op_stats[("add", a.level)] += 1
        if isinstance(b, Ciphertext):
            a, b = self._align_add(a, b)
            return a.with_data(sub_mod(a.data, b.data, self.moduli(a)))
        if isinstance(b, Plaintext):
            assert b.level == a.level and b.sdeg == a.sdeg, "pt/ct mismatch"
            p = self.moduli(a)
            return self._on_c0(a, lambda c0: sub_mod(c0, self._pt_planes(b), p))
        return self.add(a, -float(b))

    def rsub(self, b, a: Ciphertext) -> Ciphertext:
        """scalar/plaintext minus ciphertext."""
        return self.add(self.negate(a), b)

    def negate(self, a: Ciphertext) -> Ciphertext:
        return a.with_data(neg_mod(a.data, self.moduli(a)))

    # -- level / scale adjustment ------------------------------------------

    def _drop_limbs(self, a: Ciphertext, target_level: int) -> Ciphertext:
        """Raw limb drop: the declared level changes, the true scale does not."""
        Lt = self.ctx.limbs_at(target_level)
        return Ciphertext(a.data[:, :Lt], target_level, a.sdeg, a.slots)

    def level_reduce(self, a: Ciphertext, target_level: int) -> Ciphertext:
        """Descend to target_level keeping the declared scale exact: a raw
        drop where the scales agree, adjust_level's scalar fold otherwise."""
        assert target_level >= a.level
        if a.sdeg == 1 and self.ctx.scale_dec(target_level) == self.ctx.scale_dec(a.level):
            return self._drop_limbs(a, target_level)
        return self.adjust_level(a, target_level)

    def adjust_level(self, a: Ciphertext, target_level: int) -> Ciphertext:
        if a.level == target_level:
            return a
        if a.sdeg == 2:
            a = self._rescale_impl(a)
            if a.level == target_level:
                return a
            if a.level > target_level:
                raise ValueError("cannot adjust downwards")
        ctx = self.ctx
        la = a.level
        t = float(ctx.scale_dec(target_level) * ctx.drop_prime(la) / ctx.scale_dec(la))
        sc = self._scalar_limbs(1.0, la, t)
        a = Ciphertext(mulmod(a.data, sc, ctx.p_active(la)), la, 2, a.slots)
        a = self._rescale_data(a)
        # the t-fold above already landed the true scale at scale_dec(target)
        return self._drop_limbs(Ciphertext(a.data, a.level, 1, a.slots), target_level)

    def _to_sdeg2(self, a: Ciphertext) -> Ciphertext:
        sc = self._scalar_limbs(1.0, a.level, self.ctx.scale(a.level, 1))
        return replace(a, data=mulmod(a.data, sc, self.moduli(a)), sdeg=2)

    def align_group(self, cts):
        """Common (level, sdeg) for a group."""
        lvl = max(c.level for c in cts)
        out = [self.adjust_level(c, lvl) if c.level < lvl else c for c in cts]
        lvl = max(c.level for c in out)
        out = [self.adjust_level(c, lvl) if c.level < lvl else c for c in out]
        if len({c.sdeg for c in out}) > 1:
            out = [self._to_sdeg2(c) if c.sdeg == 1 else c for c in out]
        return out

    # -- rescale -----------------------------------------------------------

    def _rescale_data(self, a: Ciphertext) -> Ciphertext:
        ctx = self.ctx
        lvl = a.level
        if lvl >= ctx.params.mult_depth:
            raise RuntimeError(
                f"multiplicative depth exhausted (level {lvl} == mult_depth "
                f"{ctx.params.mult_depth}); deepen parameters or bootstrap")
        comp = ctx.params.comp
        data = a.data
        for j in range(comp):
            Ll = ctx.limbs_at(lvl) - j
            plan = ctx.rescale_plans[lvl * comp + j]
            p_rest = ctx.pc.p[: Ll - 1]
            x = self._intt(data[:, Ll - 1 : Ll], ctx.limbs_range(Ll - 1, Ll))  # [2,1,n]
            xm = torch.remainder(x, p_rest)
            t = torch.where(x >= plan.qlast_half, sub_mod(xm, plan.qlast_mod_qi, p_rest), xm)
            num = sub_mod(data[:, : Ll - 1], self._ntt(t, ctx.limbs_range(0, Ll - 1)), p_rest)
            data = mulmod(num, plan.qlast_inv, p_rest)
        return Ciphertext(data, lvl + 1, a.sdeg, a.slots)

    def _rescale_impl(self, a: Ciphertext) -> Ciphertext:
        assert a.sdeg == 2, "rescale only from scale degree 2"
        out = self._rescale_data(a)
        return Ciphertext(out.data, out.level, 1, out.slots)

    def rescale(self, a: Ciphertext) -> Ciphertext:
        self.op_stats[("rescale", a.level)] += 1
        return self._rescale_impl(a)

    # -- multiplication ----------------------------------------------------

    def mult(self, a: Ciphertext, b) -> Ciphertext:
        if isinstance(b, Ciphertext):
            le = max(a.level + (a.sdeg == 2), b.level + (b.sdeg == 2))
            self.op_stats[("mult_ct", le)] += 1
            return self._mult_ct(a, b)
        if a.sdeg == 2:
            a = self.rescale(a)
        self.op_stats[("mult_pt", a.level)] += 1
        p = self.moduli(a)
        if isinstance(b, Plaintext):
            assert b.level == a.level and b.sdeg == 1, (
                f"plaintext at level {b.level}/deg {b.sdeg}, ct at {a.level}")
            return replace(a, data=mulmod(a.data, self._pt_planes(b), p), sdeg=2)
        sc = self._scalar_limbs(float(b), a.level, self.ctx.scale(a.level, 1))
        return replace(a, data=mulmod(a.data, sc, p), sdeg=2)

    def mult_plain_at(self, a: Ciphertext, values, roll: int = 0) -> Ciphertext:
        """Multiply by np.roll(values, roll) encoded at a's (post-rescale)
        level: the roll is a plaintext automorphism applied on the device,
        so every roll of one mask shares one encode."""
        if a.sdeg == 2:
            a = self.rescale(a)
        pt = self.make_plaintext(values, a.level, 1, slots=a.slots)
        if roll % (self.ctx.params.ring_n // 2) == 0:
            return self.mult(a, pt)
        # np.roll(v, s) = slot left-rotation by -s
        g = self.ctx.galois_element_rot(-roll)
        self.op_stats[("mult_pt", a.level)] += 1
        rolled = self._apply_auto(self._pt_planes(pt), g, a.level)
        return replace(a, data=mulmod(a.data, rolled, self.moduli(a)), sdeg=2)

    def _mult_ct(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        if a.sdeg == 2:
            a = self._rescale_impl(a)
        if b.sdeg == 2:
            b = self._rescale_impl(b)
        if a.level < b.level:
            a = self.adjust_level(a, b.level)
        elif b.level < a.level:
            b = self.adjust_level(b, a.level)
        p = self.moduli(a)
        a0, a1 = a.data[0], a.data[1]
        b0, b1 = b.data[0], b.data[1]
        d0 = mulmod(a0, b0, p)
        d1 = add_mod(mulmod(a0, b1, p), mulmod(a1, b0, p), p)
        e0, e1 = self._keyswitch_core(mulmod(a1, b1, p), a.level, self._read(self.keys.relin))
        return replace(a, data=torch.stack([add_mod(d0, e0, p), add_mod(d1, e1, p)]), sdeg=2)

    def square(self, a: Ciphertext) -> Ciphertext:
        self.op_stats[("mult_ct", a.level + (a.sdeg == 2))] += 1
        if a.sdeg == 2:
            a = self._rescale_impl(a)
        p = self.moduli(a)
        a0, a1 = a.data[0], a.data[1]
        d0 = mulmod(a0, a0, p)
        cross = mulmod(a0, a1, p)
        d1 = add_mod(cross, cross, p)
        e0, e1 = self._keyswitch_core(mulmod(a1, a1, p), a.level, self._read(self.keys.relin))
        return replace(a, data=torch.stack([add_mod(d0, e0, p), add_mod(d1, e1, p)]), sdeg=2)

    # -- key switching -----------------------------------------------------

    def _modup(self, d_limb: torch.Tensor, level: int) -> torch.Tensor:
        """Hybrid ModUp: [Ll, n] eval -> per-digit extended [D, T, n] eval.

        The CRT base extension of each digit is an exact modular matmul:
        out[t] = sum_i fac[t, i] y[i] mod p_t."""
        ctx = self.ctx
        plan = ctx.ks_plans[level]
        p_a = ctx.p_active(level)
        target = ctx.target_limbs(level)
        p_t = ctx.pc.p[target]
        y = mulmod(self._intt(d_limb, ctx.active_limbs(level)), plan.dhat_inv, p_a)
        ext = torch.stack([mod_matmul(fac, y[lo:hi], p_t)
                           for fac, (lo, hi) in zip(plan.dig_ext, ctx.digit_layout(level))])
        return self._ntt(ext, target)

    def _inner_product(self, digits: torch.Tensor, level: int, ksk: KeySwitchKey):
        """sum_j digits[j] * ksk[j] over the target basis (active Q + P),
        computed on the key's active and special rows in place."""
        ctx = self.ctx
        Ll = ctx.limbs_at(level)
        D = digits.shape[0]
        p_a, p_s = ctx.p_active(level), ctx.p_special()
        out = []
        for k in (ksk.kb, ksk.ka):
            q = torch.remainder(mulmod(digits[:, :Ll], k[:D, :Ll], p_a).sum(0), p_a)
            s = torch.remainder(mulmod(digits[:, Ll:], k[:D, ctx.num_q:], p_s).sum(0), p_s)
            out.append(torch.cat([q, s]))
        return out

    def _moddown(self, c: torch.Tensor, level: int) -> torch.Tensor:
        """Exact division by P.  c: [..., Ll+K, n] -> [..., Ll, n]."""
        ctx = self.ctx
        plan = ctx.ks_plans[level]
        Ll = ctx.limbs_at(level)
        p_a, p_s = ctx.p_active(level), ctx.p_special()
        cp = self._intt(c[..., Ll:, :], ctx.special_limbs())
        y = mulmod(cp, plan.phat_inv, p_s)
        ext = self._ntt(mod_matmul(plan.pext, y, p_a), ctx.active_limbs(level))
        return mulmod(sub_mod(c[..., :Ll, :], ext, p_a), plan.p_inv_mod_qi, p_a)

    def _keyswitch_core(self, d_limb, level: int, ksk: KeySwitchKey):
        acc0, acc1 = self._inner_product(self._modup(d_limb, level), level, ksk)
        e = self._moddown(torch.stack([acc0, acc1]), level)
        return e[0], e[1]

    # -- rotations ---------------------------------------------------------

    def _rot_key(self, g: int) -> KeySwitchKey:
        assert g in self.keys.rot, f"missing rotation key for galois {g}"
        return self._read(self.keys.rot[g])

    def _apply_auto(self, data: torch.Tensor, g: int, level: int,
                    target: bool = False) -> torch.Tensor:
        """sigma_g on evaluation-domain planes [..., L, n]: the gather, or
        the affine path's products where `use_affine` is on.  `target`: the
        planes are the extended basis, the active Q limbs at `level` then
        the special primes."""
        ctx = self.ctx
        if not self.use_affine:
            return data[..., ctx.galois_perm(g)]
        limbs = ctx.target_limbs(level) if target else ctx.active_limbs(level)
        tables = self._read(ctx.auto_tables()).select(limbs)
        return apply_affine(data, self._read(ctx.galois_affine(g)), tables)

    def _automorphism(self, a: Ciphertext, g: int, ksk: KeySwitchKey | None = None,
                      gather: bool = False) -> Ciphertext:
        """sigma_g and the key switch back to s; `gather` takes the gather
        whatever `use_affine` says."""
        ksk = self._rot_key(g) if ksk is None else ksk
        d = a.data[..., self.ctx.galois_perm(g)] if gather else self._apply_auto(a.data, g, a.level)
        e0, e1 = self._keyswitch_core(d[1], a.level, ksk)
        return a.with_data(torch.stack([add_mod(d[0], e0, self.moduli(a)), e1]))

    def rotate(self, a: Ciphertext, r: int) -> Ciphertext:
        """Left slot-rotation by r (negative = right)."""
        if r % (self.ctx.params.ring_n // 2) == 0:
            return a
        self.op_stats[("rot", a.level)] += 1
        return self._automorphism(a, self.ctx.galois_element_rot(r))

    def rotate_with_key(self, a: Ciphertext, r: int, ksk: KeySwitchKey) -> Ciphertext:
        """Left slot-rotation by r with the key `ksk`, key-switched even where
        r is a multiple of the slot count (galois element 1: a key to s
        itself).  The sharded DirectSort's batch offsets, one uniform program
        for every batch; always by the gather, as in the JAX package."""
        self.op_stats[("rot", a.level)] += 1
        return self._automorphism(a, self.ctx.galois_element_rot(r), ksk, gather=True)

    def conjugate(self, a: Ciphertext) -> Ciphertext:
        self.op_stats[("rot", a.level)] += 1
        return self._automorphism(a, 2 * self.ctx.params.ring_n - 1)

    def rotate_precompute(self, a: Ciphertext) -> torch.Tensor:
        """Hoisted ModUp of c1: the extended digits [dnum, Ll+K, n] that
        every `rotate_hoisted` of `a` shares."""
        self.op_stats[("rot_pre", a.level)] += 1
        return self._modup(a.data[1], a.level)

    def rotate_hoisted(self, a: Ciphertext, pre: torch.Tensor, r: int) -> Ciphertext:
        """Rotation over a shared precompute: sigma_g(ModUp(x)) =
        ModUp(sigma_g(x)) up to gadget-annihilated extension noise, so the
        permutation applies to the extended digits (active limbs and
        specials alike)."""
        if r % (self.ctx.params.ring_n // 2) == 0:
            return a
        self.op_stats[("rot_hoisted", a.level)] += 1
        g = self.ctx.galois_element_rot(r)
        ksk = self._rot_key(g)
        digits = self._apply_auto(pre, g, a.level, target=True)
        acc0, acc1 = self._inner_product(digits, a.level, ksk)
        e = self._moddown(torch.stack([acc0, acc1]), a.level)
        c0 = add_mod(self._apply_auto(a.data[0], g, a.level), e[0], self.ctx.p_active(a.level))
        return Ciphertext(torch.stack([c0, e[1]]), a.level, a.sdeg, a.slots)

    # -- batched linear combinations ---------------------------------------

    def combo(self, cts, rows, consts) -> list:
        """Batched sum_b rows[r][b] * cts[b] + consts[r] -> R ciphertexts.

        Inputs are aligned to a common (level, sdeg=1) first; outputs are
        sdeg 2.  One per-limb modular matmul [R, B] @ [B, 2n] replaces R*B
        scalar multiplies."""
        assert len(cts) >= 1
        lvl = max(c.level + (1 if c.sdeg == 2 else 0) for c in cts)
        aligned = []
        for c in cts:
            if c.sdeg == 2:
                c = self.rescale(c)
            if c.level < lvl:
                c = self.adjust_level(c, lvl)
            aligned.append(c)
        Ll = self.ctx.limbs_at(lvl)
        rows = np.asarray(rows, dtype=np.float64)
        consts = np.asarray(consts, dtype=np.float64)
        R, B = rows.shape
        assert B == len(cts) and consts.shape == (R,)
        coeff, const = self._combo_residues(rows, consts, lvl)
        self.op_stats[("combo", lvl, B, R)] += 1
        p = self.ctx.p_active(lvl)
        n = aligned[0].data.shape[-1]
        # limb chunks bound the stacked operand (and mod_matmul's float64
        # halves of it) to _COMBO_CHUNK_BYTES: at N=1024 the sinc's 64 babies
        # over a whole chain would not fit the device beside them
        step = max(1, _COMBO_CHUNK_BYTES // (B * 2 * n * 8))
        outs = []
        for lo in range(0, Ll, step):
            hi = min(lo + step, Ll)
            x = torch.stack([c.data[:, lo:hi] for c in aligned])    # [B, 2, l, n]
            x = x.permute(2, 0, 1, 3).reshape(hi - lo, B, 2 * n)
            outs.append(mod_matmul(coeff[lo:hi], x, p[lo:hi, :, None]))   # [l, R, 2n]
        out = outs[0] if len(outs) == 1 else torch.cat(outs)
        out = out.reshape(Ll, R, 2, n).permute(1, 2, 0, 3)         # [R, 2, L, n]
        d0 = add_mod(out[:, 0], const, p)
        out = torch.stack([d0, out[:, 1]], dim=1)
        slots = aligned[0].slots
        return [Ciphertext(out[r], lvl, 2, slots) for r in range(R)]

    def _combo_residues(self, rows: np.ndarray, consts: np.ndarray, lvl: int):
        """`combo`'s coefficient residues [L, R, B] and constant residues
        [R, L, 1] on the device, memoised by content."""
        key = (lvl, rows.shape, rows.tobytes(), consts.tobytes())
        hit = self._combo_memo.get(key)
        if hit is None:
            Ll = self.ctx.limbs_at(lvl)
            R = rows.shape[0]
            ps = np.array(self.ctx.q_primes[:Ll], dtype=np.int64)
            m = np.rint(rows * self.ctx.scale(lvl, 1)).astype(np.int64)
            coeff_res = m[None, :, :] % ps[:, None, None]
            s2 = float(self.ctx.scale_dec(lvl) ** 2)
            const_res = np.zeros((R, Ll, 1), dtype=np.int64)
            for r in range(R):
                if consts[r] != 0.0:
                    mi = int(consts[r] * s2)
                    const_res[r, :, 0] = [mi % int(p) for p in ps]
            hit = self._combo_memo[key] = (self.ctx.tensor(coeff_res),
                                           self.ctx.tensor(const_res))
        return self._read(hit)

    # -- misc --------------------------------------------------------------

    def zeros_like(self, a: Ciphertext) -> Ciphertext:
        return a.with_data(torch.zeros_like(a.data))

    def add_many(self, cts) -> Ciphertext:
        out = cts[0]
        for c in cts[1:]:
            out = self.add(out, c)
        return out
