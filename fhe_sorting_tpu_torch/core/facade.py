"""Encryption facade (port of `fhe_sorting_tpu/core/facade.py`).

`Encryption` owns only public material (the serving path never decrypts);
`DebugEncryption` additionally needs the secret key so that tests can
decrypt intermediates.
"""

from __future__ import annotations

import numpy as np

from .cipher import Ciphertext
from .context import Context
from .keys import Keys


class Encryption:
    """Encrypt-only facade: wraps the public key."""

    def __init__(self, keys: Keys):
        self._keys = keys
        self.ctx: Context = keys.ctx

    def encrypt_input(self, values, slots: int | None = None) -> Ciphertext:
        """Encrypts after asserting that the vector fits the slot capacity."""
        values = np.asarray(values, dtype=np.float64)
        assert len(values) <= self.ctx.params.max_slots, "input too long for ring"
        return self._keys.encrypt(values, slots=slots)


class DebugEncryption(Encryption):
    """Adds decryption and probes."""

    SMALL = 1e-9

    def get_decrypt(self, ct: Ciphertext, num_values: int | None = None):
        out = self._keys.decrypt(ct, num_values)
        out[np.abs(out) < self.SMALL] = 0.0  # small-value thresholding
        return out

    def print_pt(self, ct: Ciphertext, count: int = 8, label: str = ""):
        vals = self.get_decrypt(ct, count)
        print(f"{label}[level {ct.level} sdeg {ct.sdeg} slots {ct.slots}] "
              f"{np.round(vals, 5)}")


def print_pt(enc: Encryption, ct: Ciphertext, count: int = 8, label: str = ""):
    """Prints only when `enc` can decrypt."""
    if isinstance(enc, DebugEncryption):
        enc.print_pt(ct, count, label)
