"""Modular arithmetic on int64 residue tensors.

Every prime of the chain is below 2^31, so residues in [0, p) multiply to
less than 2^62 and a general mulmod is one int64 product and one remainder.
That gives the same canonical residue as the Shoup and Barrett u32 code of
`fhe_sorting_tpu.core.modmath`, so results are bit-identical.  PyTorch has
no usable uint32 arithmetic on the CPU, which is why the port is int64
throughout.

`host_shoup` is the reference's numpy Shoup-quotient helper, used where
tables are built on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def add_mod(a: torch.Tensor, b: torch.Tensor, p) -> torch.Tensor:
    t = a + b
    return torch.where(t >= p, t - p, t)


def sub_mod(a: torch.Tensor, b: torch.Tensor, p) -> torch.Tensor:
    t = a - b
    return torch.where(t < 0, t + p, t)


def neg_mod(a: torch.Tensor, p) -> torch.Tensor:
    return torch.where(a == 0, a, p - a)


def mulmod(a: torch.Tensor, b, p) -> torch.Tensor:
    """a * b mod p for residues a, b in [0, p), p < 2^31."""
    return torch.remainder(a * b, p)


def host_shoup(b, p: int) -> np.ndarray:
    """floor(b * 2^32 / p) as u32 (b may be array or scalar, values < p)."""
    b = np.asarray(b, dtype=np.uint64)
    return ((b << np.uint64(32)) // np.uint64(p)).astype(np.uint32)


@dataclass(frozen=True)
class PrimeConsts:
    """Per-limb primes, [L, 1] int64 for broadcast over coefficients."""

    p: torch.Tensor
