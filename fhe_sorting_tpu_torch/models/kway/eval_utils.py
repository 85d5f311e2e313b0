"""Small ciphertext helpers of the k-way network.

Port of `fhe_sorting_tpu/models/kway/eval_utils.py` (the reference's
EvalUtils.{h,cpp}):

  * mult_by_int      - exact integer scaling by binary double-and-add (adds
                       cost no level, unlike a scalar multiply's rescale);
  * check_level_and_boot[2] - bootstrap when the remaining depth cannot
                       cover `required_level + 1`;
  * flip_ctxt        - x -> 1 - x (or mask - x);
  * left/right_rotate - binary decomposition into power-of-two rotations;
  * debug_with_sk    - decrypt-print through a key set that holds the
                       secret (a secret-free one raises `SecretKeyMissing`).
"""

from __future__ import annotations

import numpy as np

from ...core.cipher import Ciphertext


def mult_by_int(ev, ct: Ciphertext, coeff: int) -> Ciphertext:
    """ct * coeff for an integer coeff by double-and-add (EvalUtils.cpp:18-43):
    level and scale degree stay as they are."""
    if coeff == 0:
        return ev.zeros_like(ct)
    if coeff < 0:
        coeff = -coeff
        out = origin = ev.negate(ct)
    else:
        out = origin = ct
    bits = []
    while coeff > 0:
        bits.append(coeff % 2)
        coeff //= 2
    for i in range(len(bits) - 1, 0, -1):
        out = ev.add(out, out)
        if bits[i - 1]:
            out = ev.add(out, origin)
    return out


def check_level_and_boot(ev, ct: Ciphertext, required_level: int,
                         bootstrap_fn=None, verbose: bool = False) -> Ciphertext:
    """EvalUtils.cpp:57-86: refresh when mult_depth - level < required + 1."""
    depth = ev.ctx.params.mult_depth
    if depth - ct.level < required_level + 1:
        if bootstrap_fn is None:
            raise RuntimeError(
                f"depth exhausted at level {ct.level} (need {required_level}"
                f"+1 of {depth}) and no bootstrap_fn provided")
        if verbose:
            print(f"bootstrapping at level {ct.level} "
                  f"(mult_depth {depth}, required {required_level})")
        ct = bootstrap_fn(ct)
    return ct


def check_level_and_boot2(ev, ct1: Ciphertext, ct2: Ciphertext,
                          required_level: int, bootstrap_fn=None,
                          verbose: bool = False):
    """EvalUtils.cpp:88-94: the two-ciphertext variant."""
    return (check_level_and_boot(ev, ct1, required_level, bootstrap_fn, verbose),
            check_level_and_boot(ev, ct2, required_level, bootstrap_fn, verbose))


def flip_ctxt(ev, ct: Ciphertext, mask=None) -> Ciphertext:
    """EvalUtils.cpp:96-104: 1 - x, or mask - x with a plaintext mask."""
    if mask is None:
        return ev.rsub(1.0, ct)
    neg = ev.negate(ct)
    pt = ev.make_plaintext(mask, neg.level, neg.sdeg, slots=neg.slots)
    return ev.add(neg, pt)


def left_rotate(ev, ct: Ciphertext, r: int) -> Ciphertext:
    """EvalUtils.cpp:106-126: binary decomposition into 2^i rotations."""
    out = ct
    power = 1
    while r > 0:
        if r % 2:
            out = ev.rotate(out, power)
        r //= 2
        power *= 2
    return out


def right_rotate(ev, ct: Ciphertext, r: int) -> Ciphertext:
    """EvalUtils.cpp:128-147."""
    out = ct
    power = 1
    while r > 0:
        if r % 2:
            out = ev.rotate(out, -power)
        r //= 2
        power *= 2
    return out


def debug_with_sk(keys, ct: Ciphertext, length: int = 20, label: str = "") -> None:
    """EvalUtils.cpp:149-180: print the head and tail of the decrypted vector
    and its largest magnitude."""
    vals = keys.decrypt(ct)
    if label:
        print(f"check {label}")
    head = ", ".join(f"({i}, {vals[i]:.6g})" for i in range(min(20, length)))
    tail = ", ".join(f"({i}, {vals[i]:.6g})"
                     for i in range(max(0, len(vals) - 20), len(vals)))
    idx = int(np.argmax(np.abs(vals)))
    print(head)
    print(tail)
    print(f"{label} max val = {idx}, {abs(vals[idx]):.6g}")
