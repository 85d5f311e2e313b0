"""Rotation-step decomposition and composed rotations over a limited key set.

Port of `fhe_sorting_tpu/ops/rotation.py`: `Decomposer` splits an arbitrary
rotation amount into keyed steps (greedy large-step peeling, then NAF /
binary over the available power-of-two steps), `RotationComposer.rotate`
applies them, and `RotationTree` reuses one hoisted ModUp precompute across
the first composed step.

Every applied step costs a key switch (the dominant op), so the step count
matters.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..core.cipher import Ciphertext


class DecomposeAlgo(enum.Enum):
    BINARY = "binary"
    NAF = "naf"
    BNAF = "bnaf"


@dataclass
class RotationStats:
    """Counts of what a composer did."""

    rotations: int = 0
    fast_rotations: int = 0
    composed: int = 0
    lazy_keygens: int = 0
    calls: dict = field(default_factory=dict)

    def record(self, r: int):
        self.calls[r] = self.calls.get(r, 0) + 1


def naf_digits(x: int):
    """Non-adjacent form of x as list of (power, sign)."""
    out = []
    k = 0
    while x != 0:
        if x & 1:
            d = 2 - (x & 3)  # 1 or -1
            out.append((k, d))
            x -= d
        x >>= 1
        k += 1
    return out


class Decomposer:
    """Split rotation amounts into available keyed steps."""

    def __init__(self, steps, wrap: int, algo: DecomposeAlgo = DecomposeAlgo.NAF):
        self.signed = set(int(s) for s in steps if s)
        self.steps = sorted(set(abs(int(s)) for s in steps if s))
        self.wrap = wrap
        self.algo = algo
        self._pows = [s for s in self.steps if s & (s - 1) == 0]

    def decompose(self, r: int):
        """Signed steps summing to r mod wrap, restricted to steps whose
        (signed) rotation keys exist.  Fallback order: NAF over power-of-two
        keys -> closest-signed greedy (handles sparse bases like the signed
        powers of four the staged MEHP24 path uses: each matrix-ladder step
        2^a or 2^a - 2^b composes from <= 4 keys) -> all-positive greedy."""
        try:
            parts = self._decompose_inner(r)
            if all(p in self.signed for p in parts):
                return parts
        except ValueError:
            pass
        parts = self._closest_signed(r)
        if parts is not None:
            return parts
        # all-positive greedy fallback on the canonical representative
        rr = r % self.wrap
        pos = sorted((s for s in self.signed if s > 0), reverse=True)
        out = []
        while rr:
            s = next((s for s in pos if s <= rr), None)
            if s is None:
                raise ValueError(
                    f"no keyed decomposition for rotation {r} "
                    f"(available: {sorted(self.signed)})"
                )
            out.append(s)
            rr -= s
        return out

    def _closest_signed(self, r: int, max_steps: int = 12):
        """Repeatedly subtract the available signed step closest to the
        remainder; exact and short for near-geometric bases."""
        if not self.signed:
            return None
        r = r % self.wrap
        if r > self.wrap // 2:
            r -= self.wrap
        out = []
        while r and len(out) < max_steps:
            s = min(self.signed, key=lambda k: abs(r - k))
            if abs(r - s) >= abs(r):
                return None  # no progress
            out.append(s)
            r -= s
        return out if r == 0 else None

    def _decompose_inner(self, r: int):
        r = r % self.wrap
        if r == 0:
            return []
        # minimal representative in (-wrap/2, wrap/2]
        if r > self.wrap // 2:
            r -= self.wrap
        sign = 1 if r > 0 else -1
        mag = abs(r)
        out = []
        # greedy large-step peeling with non-power steps
        for s in sorted(self.steps, reverse=True):
            if s & (s - 1) == 0:
                continue
            while mag >= s:
                out.append(sign * s)
                mag -= s
        # remaining magnitude over power-of-two keys
        if mag and self._pows:
            largest = self._pows[-1]
            while mag >= 2 * largest or (mag > largest and mag & (mag - 1)):
                out.append(sign * largest)
                mag -= largest
        if mag:
            if self.algo == DecomposeAlgo.BINARY:
                k = 0
                while mag:
                    if mag & 1:
                        if (1 << k) not in self._pows:
                            raise ValueError(
                                f"no key for power step {1 << k} (r={r})"
                            )
                        out.append(sign * (1 << k))
                    mag >>= 1
                    k += 1
            else:
                for k, d in naf_digits(mag):
                    if (1 << k) not in self._pows:
                        raise ValueError(f"no key for power step {1 << k} (r={r})")
                    out.append(sign * d * (1 << k))
        return out


class RotationComposer:
    """Rotate with whatever keys exist.

    `lazy_key_budget`: when set, rotation keys missing at call time are
    generated on the device just in time (`Keys.gen_rotation_keys`) and at
    most `lazy_key_budget` such keys stay resident - the least recently
    used lazy key is dropped beyond that.  A sort whose distinct giant-step
    keys would not fit device memory uses each in one batch iteration only,
    so a small rotating pool suffices.  Keys present before the composer
    was built are never evicted."""

    def __init__(self, ev, steps, wrap: int | None = None,
                 algo: DecomposeAlgo = DecomposeAlgo.NAF,
                 lazy_key_budget: int | None = None):
        self.ev = ev
        nh = ev.ctx.params.ring_n // 2
        self.wrap = wrap if wrap is not None else nh
        self.steps = set()
        for s in steps:
            self.steps.add(int(s))
        self.dec = Decomposer(steps, self.wrap, algo)
        self.stats = RotationStats()
        self.lazy_key_budget = lazy_key_budget
        self._lazy_lru: list = []  # galois elements generated on demand

    def _has_key(self, r: int) -> bool:
        g = self.ev.ctx.galois_element_rot(r)
        return g in self.ev.keys.rot

    def _ensure_key(self, r: int) -> bool:
        """True if a direct key for r exists (possibly just generated)."""
        if self._has_key(r):
            g = self.ev.ctx.galois_element_rot(r)
            if g in self._lazy_lru:  # refresh LRU position
                self._lazy_lru.remove(g)
                self._lazy_lru.append(g)
            return True
        if self.lazy_key_budget is None:
            return False
        keys = self.ev.keys
        g = self.ev.ctx.galois_element_rot(r)
        keys.gen_rotation_keys([r])
        self._lazy_lru.append(g)
        self.stats.lazy_keygens += 1
        while len(self._lazy_lru) > self.lazy_key_budget:
            old = self._lazy_lru.pop(0)
            keys.rot.pop(old, None)
        return True

    def rotate(self, ct: Ciphertext, r: int) -> Ciphertext:
        self.stats.record(r)
        r = r % self.wrap
        if r == 0:
            return ct
        if self._ensure_key(r):
            self.stats.rotations += 1
            return self.ev.rotate(ct, r)
        out = ct
        parts = self.dec.decompose(r)
        self.stats.composed += 1
        for s in parts:
            self.stats.rotations += 1
            out = self.ev.rotate(out, s)
        return out

    def rotate_hoisted(self, ct: Ciphertext, pre, r: int) -> Ciphertext:
        """Use a shared hoisted precompute for the first step; compose rest."""
        r = r % self.wrap
        if r == 0:
            return ct
        if self._ensure_key(r):
            self.stats.fast_rotations += 1
            return self.ev.rotate_hoisted(ct, pre, r)
        parts = self.dec.decompose(r)
        out = self.ev.rotate_hoisted(ct, pre, parts[0])
        self.stats.fast_rotations += 1
        for s in parts[1:]:
            self.stats.rotations += 1
            out = self.ev.rotate(out, s)
        return out


class _TreeNode:
    """One rotation-prefix node: cached rotated ciphertext + lazily created
    hoisted ModUp precompute shared by all children."""

    __slots__ = ("step", "children", "ct", "pre")

    def __init__(self, step: int):
        self.step = step
        self.children: dict = {}
        self.ct: Ciphertext | None = None
        self.pre = None


class RotationTree:
    """Shared-prefix rotation tree.

    Rotations are decomposed into keyed steps; decompositions sharing a step
    prefix share the intermediate rotated ciphertexts (per-node cache), and
    every node amortizes ONE hoisted ModUp precompute over all of its
    children.  Hoisting is unconditional: a hoisted rotation replaces the
    per-rotation ModUp with the shared one at identical cost even for a
    single child."""

    def __init__(self, composer: RotationComposer):
        self.comp = composer
        self.root = _TreeNode(0)

    def build(self, ct: Ciphertext, rotations=None):
        """Anchor the tree at `ct` (`rotations` may pre-register a range so
        shared prefixes are discovered up front; registration is otherwise
        lazy on first rotate)."""
        self.root = _TreeNode(0)
        self.root.ct = ct
        for r in rotations or ():
            self._parts(r)  # validates keyed decompositions exist
        return self

    def _parts(self, r: int):
        r = r % self.comp.wrap
        if r == 0:
            return []
        if self.comp._has_key(r):
            return [r]
        return self.comp.dec.decompose(r)

    def rotate(self, r: int) -> Ciphertext:
        """Rotate the anchored ciphertext by r, reusing every cached
        shared-prefix intermediate."""
        assert self.root.ct is not None, "RotationTree.build(ct) first"
        self.comp.stats.record(r)
        node = self.root
        for step in self._parts(r):
            child = node.children.get(step)
            if child is None:
                child = _TreeNode(step)
                node.children[step] = child
            if child.ct is None:
                if node.pre is None:
                    node.pre = self.comp.ev.rotate_precompute(node.ct)
                child.ct = self.comp.ev.rotate_hoisted(node.ct, node.pre, step)
                self.comp.stats.fast_rotations += 1
            node = child
        return node.ct
