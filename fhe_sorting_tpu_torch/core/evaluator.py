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

Key switching is hybrid: ModUp (INTT, CRT base extension of every digit,
NTT of every digit in one batched call), the inner product with the key,
then ModDown (division by P).  Every NTT goes through `core/ntt.py`, which
on a GPU launches the CUDA kernel of the context's tables: K1 (four-step)
or K2 (butterfly).  Limb subsets are index tensors cached on the context, so no table is
sliced or copied per op.  The base extensions of ModUp and ModDown go
through `core/rns_bconv.py`, which on a GPU launches K4 once each.  The
exact division by a dropped modulus, in every rescale (by q_last) and at
the end of ModDown (by P), goes through `core/rns_div.py`, which on a GPU
launches K3 on either side of the NTT.

The key switch and the rescale compute the rows `Context.ks_rows` and
`Context.rescale_rows` give for `limb_part` ((1, 0) here: every row), and
reach the other rows' coefficients through two hooks, `_gather_rows`
(ModUp's digit planes, ModDown's special planes) and `_drop_limb` (the
dropped limb's coefficients).  Here the hooks are the identity and an
INTT; `parallel/limb_parallel.py` supplies a limb rank's rows and
collectives.  `ntt_planes` counts the limb planes each of them, and the
plaintext encodes, transform.

While `core/trace.py` records, each op and each part of the key switch
(ModUp, the inner product with the key, ModDown) runs inside a span named
`ev.<op>` (`ev.add`, `ev.rescale`, `ev.modup`, ...), so a profile of an
eager run can charge every kernel to the op that launched it
(`utils/profile_sort.py`).  A replayed CUDA graph runs no Python, and opens
none.

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
from . import rns_bconv, rns_div, trace
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
        # limb planes through the NTT and INTT, by what transformed them
        # ("modup", "moddown", "rescale", "plaintext", ...)
        self.ntt_planes: Counter = Counter()
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

    def _ntt(self, x, limbs, what: str = "other"):
        self.ntt_planes[what] += x.numel() // x.shape[-1]
        return nttm.ntt(x, self.ctx.tables, limbs)

    def _intt(self, x, limbs, what: str = "other"):
        self.ntt_planes[what] += x.numel() // x.shape[-1]
        return nttm.intt(x, self.ctx.tables, limbs)

    def _scalar_limbs(self, c: float, level: int, scale: float) -> torch.Tensor:
        m = int(np.rint(np.float64(c) * scale))
        Ll = self.ctx.limbs_at(level)
        hit = self._scalar_memo.get((m, Ll))
        if hit is None:
            hit = self._scalar_memo[(m, Ll)] = self.ctx.tensor(
                [[m % p] for p in self.ctx.q_primes[:Ll]])
        return self._read(self._own(hit))

    # The limb-local ops (add, sub, negate, the products and the tensor
    # product, the automorphism's permutation, `combo`) take their primes
    # from `_primes`, and the rows of a whole-chain tensor [..., L, n]
    # (a plaintext's planes, scalar and `combo` residues) from `_own`; the
    # key switch and the rescale take their rows from `limb_part`.  A
    # limb-parallel evaluator overrides those to run the same ops on its
    # own limbs.

    limb_part = (1, 0)      # (ranks of the limb axis, this rank's index)

    def _own(self, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """The rows, along its limb axis `dim`, of a whole tensor that the
        ops compute on."""
        return x

    def _primes(self, level: int) -> torch.Tensor:
        """The primes [L, 1] of the limb planes at `level` the ops compute on."""
        return self.ctx.p_active(level)

    def _rows_at(self, level: int) -> int:
        """The number of limb planes at `level` the ops compute on."""
        return self.ctx.limbs_at(level)

    def moduli(self, a: Ciphertext) -> torch.Tensor:
        """The primes [L, 1] of a's limb planes."""
        return self._primes(a.level)

    def _pt_planes(self, pt: Plaintext) -> torch.Tensor:
        """The plaintext's limb planes that the ops compute on."""
        return self._own(pt.data)

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
        pt = Plaintext(self._ntt(res, ctx.active_limbs(level), "plaintext"), level, sdeg, s)
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

    @trace.op("ev.add")
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

    @trace.op("ev.sub")
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

    @trace.op("ev.negate")
    def negate(self, a: Ciphertext) -> Ciphertext:
        return a.with_data(neg_mod(a.data, self.moduli(a)))

    # -- level / scale adjustment ------------------------------------------

    def _drop_limbs(self, a: Ciphertext, target_level: int) -> Ciphertext:
        """Raw limb drop: the declared level changes, the true scale does not."""
        Lt = self._rows_at(target_level)
        return replace(a, data=a.data[:, :Lt], level=target_level)

    def level_reduce(self, a: Ciphertext, target_level: int) -> Ciphertext:
        """Descend to target_level keeping the declared scale exact: a raw
        drop where the scales agree, adjust_level's scalar fold otherwise."""
        assert target_level >= a.level
        if a.sdeg == 1 and self.ctx.scale_dec(target_level) == self.ctx.scale_dec(a.level):
            return self._drop_limbs(a, target_level)
        return self.adjust_level(a, target_level)

    @trace.op("ev.adjust_level")
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
        a = replace(a, data=mulmod(a.data, sc, self._primes(la)), sdeg=2)
        a = self._rescale_data(a)
        # the t-fold above already landed the true scale at scale_dec(target)
        return self._drop_limbs(replace(a, sdeg=1), target_level)

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

    def _drop_limb(self, data: torch.Tensor, limb: int):
        """(coefficients [2, 1, n] of the top limb `limb`, the other rows):
        the rescale's hook for the limb it drops."""
        x = self._intt(data[:, limb : limb + 1], self.ctx.limbs_range(limb, limb + 1), "rescale")
        return x, data[:, :limb]

    @trace.op("ev.rescale")
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
            rows = ctx.rescale_rows(lvl * comp + j, *self.limb_part)
            x, rest = self._drop_limb(data, Ll - 1)                      # [2,1,n]
            t = rns_div.lift(x, rows.p, rows.qlast_mod_qi, rows.qlast_half)
            data = rns_div.sub_scale(rest, self._ntt(t, rows.limbs, "rescale"), rows.p,
                                     rows.qlast_inv)
        return replace(a, data=data, level=lvl + 1)

    def _rescale_impl(self, a: Ciphertext) -> Ciphertext:
        assert a.sdeg == 2, "rescale only from scale degree 2"
        out = self._rescale_data(a)
        return replace(out, sdeg=1)

    def rescale(self, a: Ciphertext) -> Ciphertext:
        self.op_stats[("rescale", a.level)] += 1
        return self._rescale_impl(a)

    # -- multiplication ----------------------------------------------------

    @trace.op("ev.mult")
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

    @trace.op("ev.mult_plain_at")
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

    @trace.op("ev.mult_ct")
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

    @trace.op("ev.square")
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

    def _gather_rows(self, y: torch.Tensor, limbs: int) -> torch.Tensor:
        """The whole [..., limbs, n] coefficient planes of which `y` holds
        the rows this evaluator computes: the key switch's hook before a
        base extension, which reads every row."""
        return y

    @trace.op("ev.modup")
    def _modup(self, d_limb: torch.Tensor, level: int) -> torch.Tensor:
        """Hybrid ModUp: [Ll, n] eval -> per-digit extended [D, T, n] eval.

        The CRT base extension of each digit (`rns_bconv`: y = x dhat_inv,
        out[t] = sum_i fac[t, i] y[i] mod p_t) is exact row by row, so an
        evaluator computes the target rows it holds from the whole digit
        planes."""
        ctx = self.ctx
        rows = ctx.ks_rows(level, *self.limb_part)
        Ll = ctx.limbs_at(level)
        x = self._gather_rows(self._intt(d_limb, rows.active, "modup"), Ll)
        ext = rns_bconv.base_extend(x[None], rows.dhat_inv, ctx.p_active(level), rows.dig_ext,
                                    rows.p_target, ctx.digit_layout(level))
        return self._ntt(ext, rows.target, "modup")

    @trace.op("ev.inner_product")
    def _inner_product(self, digits: torch.Tensor, level: int, ksk: KeySwitchKey):
        """sum_j digits[j] * ksk[j] over the target basis (active Q + P),
        computed on the key's active and special rows in place."""
        rows = self.ctx.ks_rows(level, *self.limb_part)
        a, D = rows.n_active, digits.shape[0]
        p_a, p_s = rows.p_active, rows.p_special
        out = []
        for k in (ksk.kb, ksk.ka):
            q = torch.remainder(mulmod(digits[:, :a], k[:D, :a], p_a).sum(0), p_a)
            s = torch.remainder(mulmod(digits[:, a:], k[:D, rows.key_special:], p_s).sum(0), p_s)
            out.append(torch.cat([q, s]))
        return out

    @trace.op("ev.moddown")
    def _moddown(self, c: torch.Tensor, level: int) -> torch.Tensor:
        """Exact division by P.  c: [B, Ll+K, n] -> [B, Ll, n]."""
        ctx = self.ctx
        rows = ctx.ks_rows(level, *self.limb_part)
        a, p_a, K = rows.n_active, rows.p_active, ctx.num_sp
        cp = self._gather_rows(self._intt(c[..., a:, :], rows.special, "moddown"), K)
        ext = rns_bconv.base_extend(cp, rows.phat_inv, ctx.p_special(), rows.pext, p_a,
                                    ((0, K),))
        ext = self._ntt(ext, rows.active, "moddown")
        return rns_div.sub_scale(c[..., :a, :], ext, p_a, rows.p_inv_mod_qi)

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

    @trace.op("ev.automorphism")
    def _automorphism(self, a: Ciphertext, g: int, ksk: KeySwitchKey | None = None,
                      gather: bool = False) -> Ciphertext:
        """sigma_g and the key switch back to s; `gather` takes the gather
        whatever `use_affine` says."""
        ksk = self._rot_key(g) if ksk is None else self._read(ksk)
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

    @trace.op("ev.rotate_hoisted")
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
        c0 = add_mod(self._apply_auto(a.data[0], g, a.level), e[0], self.moduli(a))
        return a.with_data(torch.stack([c0, e[1]]))

    # -- batched linear combinations ---------------------------------------

    @trace.op("ev.combo")
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
        Ll = self._rows_at(lvl)
        rows = np.asarray(rows, dtype=np.float64)
        consts = np.asarray(consts, dtype=np.float64)
        R, B = rows.shape
        assert B == len(cts) and consts.shape == (R,)
        coeff, const = self._combo_residues(rows, consts, lvl)
        coeff, const = self._own(coeff, 0), self._own(const)
        self.op_stats[("combo", lvl, B, R)] += 1
        p = self._primes(lvl)
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
        return [replace(aligned[0], data=out[r], sdeg=2) for r in range(R)]

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
