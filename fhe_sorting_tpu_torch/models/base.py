"""Common sorting-algorithm interface (port of `fhe_sorting_tpu/models/base.py`)."""

from __future__ import annotations

import sys
import time

import torch

from ..core.cipher import Ciphertext
from ..ops.sign import SignConfig, SignFunc


class SortBase:
    """Base class: holds the evaluator and the array size N.

    `verbose=True` prints per-phase (name, level, seconds) progress lines to
    stderr."""

    verbose: bool = False

    def __init__(self, ev, N: int):
        self.ev = ev
        self.N = N
        assert N & (N - 1) == 0, "array size must be a power of two"

    def log_phase(self, name: str, ct: Ciphertext | None = None):
        """Print one progress line (syncs the device in verbose mode so the
        elapsed time is real execution time, not dispatch time)."""
        if not self.verbose:
            return
        if ct is not None and ct.data is not None and ct.data.device.type == "cuda":
            torch.cuda.synchronize(ct.data.device)
        now = time.time()
        dt = now - self._phase_t0 if hasattr(self, "_phase_t0") else 0.0
        self._phase_t0 = now
        lvl = f" level {ct.level}" if ct is not None else ""
        print(f"# [{type(self).__name__} N={self.N}] {name}:{lvl} "
              f"(+{dt:.2f}s)", file=sys.stderr)

    def sort(self, ct: Ciphertext, sign_func: SignFunc,
             cfg: SignConfig) -> Ciphertext:
        raise NotImplementedError

    @property
    def array_size(self) -> int:
        return self.N
