"""Ciphertext / plaintext containers.

Port of `fhe_sorting_tpu/core/cipher.py` as plain dataclasses.  A
ciphertext is `data[2, L, n]` int64 (two components, L active limb planes,
n ring coefficients) in the bit-reversed NTT evaluation domain, plus:

  level  -- number of rescales performed
  sdeg   -- scale degree (1 or 2): the canonical scale is scales[level]^sdeg
  slots  -- interpreted slot count; data is `slots`-periodic in slot space,
            so SetSlots is a metadata change.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .ntt import resolve_device


@dataclass(frozen=True)
class Ciphertext:
    data: torch.Tensor | None   # [2, L, n] int64, eval domain (None in the depth meter)
    level: int
    sdeg: int
    slots: int

    @property
    def num_limbs(self) -> int:
        return self.data.shape[-2]

    def with_data(self, data) -> "Ciphertext":
        return replace(self, data=data)

    def set_slots(self, slots: int) -> "Ciphertext":
        """Reinterpret the slot count (requires `slots`-periodic content)."""
        return replace(self, slots=slots)

    @classmethod
    def from_numpy(cls, data, level: int, sdeg: int, slots: int,
                   device=None) -> "Ciphertext":
        """A ciphertext from residue planes held as numpy (e.g. a JAX
        package ciphertext's `np.asarray(ct.data)`), on `device` (None:
        the first CUDA card; pass the context's device)."""
        arr = torch.from_numpy(np.asarray(data).astype(np.int64)).to(resolve_device(device))
        return cls(arr, level, sdeg, slots)


@dataclass(frozen=True)
class Plaintext:
    """Encoded vector plaintext in the eval domain (limbs match a level)."""

    data: torch.Tensor | None   # [L, n] int64
    level: int
    sdeg: int
    slots: int
