"""RNS-CKKS context: parameters, prime chain, device tables and plans.

Port of `fhe_sorting_tpu/core/context.py`.  The prime chain, the 120-digit
Decimal scale chain, the rescale and key-switch plans and the automorphism
bookkeeping are the reference's, so both packages build the same chain from
the same parameters.  Differences:

  * every table lives on `Context.device` as int64; the device defaults
    to the first CUDA card, and the CPU has to be asked for;
  * key-switch plans hold the CRT base-extension factors as residues
    (`ntt_mxu.mod_matmul` splits them itself) rather than s8 digit planes;
  * limb subsets are int64 index tensors into the full-chain tables
    (`limbs_range`, `target_limbs`), cached per level, so no table is
    sliced or concatenated per call;
  * `ntt_impl="auto"` picks the four-step NTT with the CUDA kernel K1 when
    the device is a GPU and the ring tiles (`ntt_mxu.supported`), the
    butterfly otherwise (the CUDA kernel K2 on a GPU, plain PyTorch on the
    CPU).  The environment variable `FHE_NTT`, where set, takes the place
    of "auto" (the reference's variable also overrides a pinned
    `ntt_impl`; here a caller that pins one keeps it);
  * the gather-free automorphism's tables (`auto_tables`) and per-g
    constants (`galois_affine`) are made on first use and kept on the device,
    like the gather's permutations (`galois_perm`);
  * `frozen` (set by `Evaluator.frozen`, around a CUDA graph capture) makes
    every upload and every fill of a device cache raise `FrozenError`: a
    capture records kernels without running them, so a table made inside
    it would hold nothing until a replay, and a host-to-device copy from
    pageable memory is not allowed there at all.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from decimal import Decimal, getcontext

import numpy as np
import torch

from . import auto_affine
from . import ntt as nttm
from . import ntt_mxu
from . import primes as primes_mod
from .modmath import PrimeConsts

getcontext().prec = 120


NTT_IMPLS = ("auto", "mxu", "butterfly")


class FrozenError(RuntimeError):
    """An upload, a cache fill, a memo miss or eviction, or a key
    generation inside a frozen section (`Evaluator.frozen`)."""


@dataclass(frozen=True)
class CkksParams:
    """Declarative parameter set (the reference's `CkksParams` fields and
    defaults)."""

    ring_n: int                  # ring dimension (polynomial degree)
    mult_depth: int              # usable multiplicative depth
    scale_bits: int = 28         # log2 of the target scaling factor Delta
    comp: int = 1                # primes per level (composite scaling)
    special_bits: int = 30       # bit size of key-switch special primes
    dnum: int = 3                # hybrid key-switch digit count
    base_limbs: int = 2          # limbs reserved below the last rescale
    sigma: float = 3.2           # error std-dev
    ksk_shoup: bool = False      # carried so that a context file round-trips:
    #   the int64 mulmod keeps no Shoup table for key limbs, nothing reads it
    secret_hamming: int | None = None  # sparse ternary secret (bootstrapping)
    ntt_impl: str = "auto"       # "auto" | "butterfly" | "mxu" (four-step)
    first_mod_bits: int | None = None  # size of the bottom `comp` primes: a
    #   q0 well above Delta lets full-range messages ModRaise without a
    #   pre-scale and shrinks the EvalMod argument m*Delta/q0.  At most 30.

    def __post_init__(self):
        assert self.scale_bits % self.comp == 0, (self.scale_bits, self.comp)
        assert self.scale_bits // self.comp < 31, "per-prime size must be < 31 bits"

    @property
    def prime_bits(self) -> int:
        return self.scale_bits // self.comp

    @property
    def num_q(self) -> int:
        return self.comp * self.mult_depth + self.base_limbs

    @property
    def max_slots(self) -> int:
        return self.ring_n // 2


def _choose_prime_chain(params: CkksParams):
    """Scaling primes glued to 2^scale_bits (the reference's algorithm).

    Returns (q_primes ordered limb 0..Lq-1, canonical scales as Decimal per
    level 0..mult_depth).  Limb Lq-1 is dropped first."""
    m = 2 * params.ring_n
    delta = Decimal(2) ** params.scale_bits
    unit = Decimal(2) ** params.prime_bits

    pool = []
    want = params.num_q + 4 * params.comp * params.mult_depth + 64
    center_k = (1 << params.prime_bits) // m
    k_lo, k_hi = center_k, center_k + 1
    while len(pool) < want:
        if k_lo <= 0 and k_hi * m + 1 >= 2**31:
            break
        for k in (k_lo, k_hi):
            cand = k * m + 1
            if m < cand < 2**31 and primes_mod.is_prime(cand):
                pool.append(cand)
        k_lo -= 1
        k_hi += 1
    if len(pool) < params.num_q + 8:
        raise ValueError(
            f"prime pool exhausted: {len(pool)} primes = 1 mod {m} "
            f"near 2^{params.prime_bits}, need {params.num_q}"
        )
    pool = sorted(set(pool))
    used = set()

    def take_nearest(target: Decimal) -> int:
        best = min((p for p in pool if p not in used),
                   key=lambda p: abs(Decimal(p) - target))
        used.add(best)
        return best

    scales = [delta]
    drop_order = []
    for _ in range(params.mult_depth):
        s = scales[-1]
        target = s * s / delta
        lvl_primes = []
        prod = Decimal(1)
        for _ in range(params.comp - 1):
            q = take_nearest(unit)
            lvl_primes.append(q)
            prod *= q
        q = take_nearest(target / prod)
        lvl_primes.append(q)
        prod *= q
        drop_order.append(tuple(lvl_primes))
        scales.append(s * s / prod)

    base = [take_nearest(unit) for _ in range(params.base_limbs)]
    if params.first_mod_bits is not None:
        # the bottom `comp` limbs become NTT primes just below
        # 2^first_mod_bits: the bootstrap's ModRaise base q0 is their product
        assert params.first_mod_bits <= 30, "first_mod_bits > 30: primes must stay < 2^31"
        k = (1 << params.first_mod_bits) // m
        found = []
        while k > 0 and len(found) < params.comp:
            cand = k * m + 1
            if cand < 2**31 and cand not in used and primes_mod.is_prime(cand):
                found.append(cand)
                used.add(cand)
            k -= 1
        assert len(found) == params.comp, "not enough NTT primes near 2^first_mod_bits"
        base[: params.comp] = found
    flat = [q for lvl in drop_order for q in lvl]
    return base + list(reversed(flat)), scales


@dataclass(frozen=True)
class RescalePlan:
    """Tables to divide by one dropped prime (exact rounding)."""

    qlast_mod_qi: torch.Tensor   # [Ll-1, 1]
    qlast_inv: torch.Tensor      # [Ll-1, 1] q_drop^{-1} mod q_i
    qlast_half: int


@dataclass(frozen=True)
class KeySwitchPlan:
    """Everything key switching needs at one ciphertext level."""

    dhat_inv: torch.Tensor       # [Ll, 1] per-limb (D_j/q_i)^{-1} mod q_i
    dig_ext: tuple               # per digit [T, len(digit)] CRT factors
    phat_inv: torch.Tensor       # [K, 1]
    pext: torch.Tensor           # [Ll, K] P-hat residues mod active primes
    p_inv_mod_qi: torch.Tensor   # [Ll, 1]


class Context:
    """Parameters, prime chain and device tables of one CKKS instance."""

    def __init__(self, params: CkksParams, device=None):
        """`device=None` is the first CUDA card (an error where there is
        none); pass "cpu" to run on the CPU."""
        self.params = params
        self.device = nttm.resolve_device(device)
        self.frozen = False
        self.q_primes, self._scales_dec = _choose_prime_chain(params)
        self.sp_primes = list(primes_mod.ntt_primes(
            params.ring_n, params.special_bits,
            -(-params.num_q // params.dnum),
            exclude=tuple(self.q_primes)))
        assert not (set(self.sp_primes) & set(self.q_primes))
        self.all_primes = list(self.q_primes) + list(self.sp_primes)
        self.num_q = len(self.q_primes)
        self.num_sp = len(self.sp_primes)
        self.P = 1
        for p in self.sp_primes:
            self.P *= p

        n = params.ring_n
        impl = params.ntt_impl
        if impl == "auto":
            impl = os.environ.get("FHE_NTT", impl)
        if impl not in NTT_IMPLS:
            raise ValueError(f"ntt_impl (or FHE_NTT) {impl!r}: expected one of "
                             f"{', '.join(NTT_IMPLS)}")
        if impl == "auto":
            impl = ("mxu" if self.device.type == "cuda"
                    and ntt_mxu.supported(n, ntt_mxu.split_n(n)[0])
                    else "butterfly")
        self.ntt_impl = impl
        host = nttm.build_host_tables(tuple(self.all_primes), n)
        self._host_psi_rev, self._host_ipsi_rev, self._host_ninv = host
        if impl == "mxu":
            self.tables = ntt_mxu.build_fs_tables(tuple(self.all_primes), n, self.device)
        else:
            self.tables = nttm.build_device_tables(tuple(self.all_primes), n,
                                                   self.device, host=host)
        self.pc = PrimeConsts(self.tensor(np.asarray(self.all_primes)[:, None]))

        self._limb_cache = {}
        self.rescale_plans = [self._build_rescale_plan(d)
                              for d in range(params.comp * params.mult_depth)]
        self.ks_plans = [self._build_ks_plan(l) for l in range(params.mult_depth + 1)]

        self._root_exp = self._compute_root_exponents()
        # position of each odd exponent in the NTT output (inverse of _root_exp)
        self._exp_pos = np.zeros(2 * n, dtype=np.int64)
        self._exp_pos[self._root_exp] = np.arange(n)
        self._galois_perm_cache = {}
        # tables and per-g constants of the gather-free automorphism
        # (`core/auto_affine.py`), made on first use
        self._auto_tables = None
        self._galois_affine_cache = {}

    def thawed(self, what: str) -> None:
        """Raise `FrozenError` naming `what` inside a frozen section."""
        if self.frozen:
            raise FrozenError(f"{what} inside a frozen section (a CUDA graph capture): "
                              f"run the call once outside it first")

    def tensor(self, x) -> torch.Tensor:
        """An int64 tensor on the context device from integers or numpy."""
        self.thawed("an upload to the device (Context.tensor)")
        return torch.from_numpy(np.asarray(x).astype(np.int64)).to(self.device)

    # -- limb index sets ---------------------------------------------------

    def limbs_range(self, lo: int, hi: int) -> torch.Tensor:
        """Global limb indices lo..hi-1 as a cached device tensor."""
        key = (lo, hi)
        if key not in self._limb_cache:
            self.thawed(f"a new limb index set {key}")
            self._limb_cache[key] = torch.arange(lo, hi, dtype=torch.int64,
                                                 device=self.device)
        return self._limb_cache[key]

    def active_limbs(self, level: int) -> torch.Tensor:
        return self.limbs_range(0, self.limbs_at(level))

    def special_limbs(self) -> torch.Tensor:
        return self.limbs_range(self.num_q, self.num_q + self.num_sp)

    def target_limbs(self, level: int) -> torch.Tensor:
        """Active Q limbs at `level` followed by the special primes."""
        key = ("target", level)
        if key not in self._limb_cache:
            self.thawed(f"a new limb index set {key}")
            self._limb_cache[key] = torch.cat(
                [self.active_limbs(level), self.special_limbs()])
        return self._limb_cache[key]

    def p_active(self, level: int) -> torch.Tensor:
        return self.pc.p[: self.limbs_at(level)]

    def p_special(self) -> torch.Tensor:
        return self.pc.p[self.num_q:]

    # -- scale bookkeeping -------------------------------------------------

    def scale(self, level: int, sdeg: int) -> float:
        return float(self._scales_dec[level] ** sdeg)

    def scale_dec(self, level: int) -> Decimal:
        return self._scales_dec[level]

    def drop_primes(self, level: int) -> tuple:
        """The comp primes removed by the rescale performed *at* `level`."""
        c = self.params.comp
        hi = self.num_q - c * level
        return tuple(self.q_primes[hi - c : hi])

    def drop_prime(self, level: int) -> int:
        out = 1
        for p in self.drop_primes(level):
            out *= p
        return out

    def limbs_at(self, level: int) -> int:
        return self.num_q - self.params.comp * level

    # -- rescale precompute ------------------------------------------------

    def _build_rescale_plan(self, drop_idx: int) -> RescalePlan:
        Ll = self.num_q - drop_idx
        q_last = self.q_primes[Ll - 1]
        rest = self.q_primes[: Ll - 1]
        return RescalePlan(
            qlast_mod_qi=self.tensor([[q_last % p] for p in rest]),
            qlast_inv=self.tensor([[pow(q_last, -1, p)] for p in rest]),
            qlast_half=(q_last + 1) // 2,
        )

    # -- key-switch precompute ---------------------------------------------

    def digit_layout(self, level: int):
        """Static digit partition of the active limbs at `level`."""
        Ll = self.limbs_at(level)
        alpha = -(-self.num_q // self.params.dnum)
        return [(lo, min(lo + alpha, Ll)) for lo in range(0, Ll, alpha)]

    def _build_ks_plan(self, level: int) -> KeySwitchPlan:
        Ll = self.limbs_at(level)
        active = self.q_primes[:Ll]
        target_primes = active + self.sp_primes
        dhat_inv = np.zeros((Ll, 1), dtype=np.int64)
        dig_ext = []
        for (lo, hi) in self.digit_layout(level):
            dp = active[lo:hi]
            D = 1
            for p in dp:
                D *= p
            dhat = [D // p for p in dp]
            for i, p in enumerate(dp):
                dhat_inv[lo + i, 0] = pow(dhat[i], -1, p)
            dig_ext.append(self.tensor(
                [[dh % pt for dh in dhat] for pt in target_primes]))
        phat = [self.P // p for p in self.sp_primes]
        return KeySwitchPlan(
            dhat_inv=self.tensor(dhat_inv),
            dig_ext=tuple(dig_ext),
            phat_inv=self.tensor([[pow(phat[i], -1, p)]
                                for i, p in enumerate(self.sp_primes)]),
            pext=self.tensor([[ph % q for ph in phat] for q in active]),
            p_inv_mod_qi=self.tensor([[pow(self.P, -1, q)] for q in active]),
        )

    # -- automorphism bookkeeping ------------------------------------------

    def _compute_root_exponents(self) -> np.ndarray:
        """exponent e_j s.t. NTT output index j = evaluation at psi^{e_j}."""
        n = self.params.ring_n
        p = self.all_primes[0]
        x_poly = np.zeros(n, dtype=np.uint64)
        x_poly[1] = 1
        vals = nttm.host_ntt(x_poly, self._host_psi_rev[0], p)
        psi = primes_mod.primitive_root_2n(p, n)
        pows = nttm.pow_table(psi, 2 * n, p)
        order = np.argsort(pows)
        return order[np.searchsorted(pows, vals, sorter=order)].astype(np.int64)

    def galois_element_rot(self, r: int) -> int:
        """Galois element for a left slot-rotation by r."""
        m = 2 * self.params.ring_n
        return pow(5, r % (self.params.ring_n // 2), m)

    def galois_perm(self, g: int) -> torch.Tensor:
        """Permutation perm with out[j] = in[perm[j]] for sigma_g in eval,
        a cached int64 tensor on the device."""
        if g not in self._galois_perm_cache:
            tgt = (g * self._root_exp) % (2 * self.params.ring_n)
            self._galois_perm_cache[g] = self.tensor(self._exp_pos[tgt])
        return self._galois_perm_cache[g]

    # -- gather-free automorphism (core/auto_affine.py) ----------------------

    def auto_tables(self) -> auto_affine.AffineAutoTables:
        """Per-limb DFT tables of the affine automorphism path, for every
        prime of the chain; built once, on first use."""
        if self._auto_tables is None:
            self.thawed("the affine automorphism tables")
            n = self.params.ring_n
            self._auto_tables = auto_affine.build_tables(
                tuple(self.all_primes), n, ntt_mxu.split_n(n)[0], self.device)
        return self._auto_tables

    def galois_affine(self, g: int) -> auto_affine.AffineAutoConsts:
        """Per-g selector matrices of the affine automorphism path, cached on
        the device."""
        if g not in self._galois_affine_cache:
            self.thawed(f"new affine automorphism constants (galois element {g})")
            n = self.params.ring_n
            self._galois_affine_cache[g] = auto_affine.build_consts(
                g, n, ntt_mxu.split_n(n)[0], self.device)
        return self._galois_affine_cache[g]
