"""Static device-memory accounting: keys x limbs x ring -> bytes, on paper.

Port of `fhe_sorting_tpu/utils/hbm_budget.py`, re-based on the card: every
number a key-basis or phase-residency plan needs is static, so the plan is
checked before any device allocation instead of found out by an
out-of-memory error.

Sizes (every plane is int64 in this package: `RESIDUE_BYTES` = 8):
  * key-switch key (hybrid, `core/keys.py`): kb + ka, each
    [digits, num_q + num_sp, ring_n]         -> 2*digits*(Lq+K)*n*8 bytes
  * ciphertext at level l (`core/cipher.py`): [2, limbs_at(l), ring_n]
                                             -> 2*Ll*n*8 bytes
  * NTT twiddle tables and plans are O(limbs * n) once per context and
    counted by the headroom fraction rather than itemized.

The capacity is the context device's own (`torch.cuda.get_device_properties`);
on the CPU there is none to ask, and the caller passes `capacity_gb`.
"""

from __future__ import annotations

import torch

RESIDUE_BYTES = torch.empty((), dtype=torch.int64).element_size()
# left for the caching allocator's slack, key-switch temporaries ([dnum, Lq+K,
# n] extended digits) and the context's tables
DEFAULT_HEADROOM_FRAC = 0.20


def device_capacity_gb(ctx) -> float:
    """Total memory of the context's CUDA device in GiB."""
    if ctx.device.type != "cuda":
        raise ValueError(
            "the context is on the CPU: there is no device capacity to read, "
            "pass capacity_gb")
    return torch.cuda.get_device_properties(ctx.device).total_memory / (1 << 30)


def ksk_bytes(ctx) -> int:
    """One key-switch key (rotation/relin/conj) resident size in bytes."""
    n = ctx.params.ring_n
    digits = len(ctx.digit_layout(0))      # dnum, or fewer on a very short chain
    return 2 * digits * (ctx.num_q + ctx.num_sp) * n * RESIDUE_BYTES


def ct_bytes(ctx, level: int = 0) -> int:
    """One ciphertext at `level` in bytes."""
    return 2 * ctx.limbs_at(level) * ctx.params.ring_n * RESIDUE_BYTES


def phase_bytes(ctx, n_rot_keys: int, n_cts: int, *, relin: bool = True,
                work_cts: int = 4) -> int:
    """Resident bytes for one execution phase.

    n_rot_keys : rotation keys resident during the phase
    n_cts      : long-lived ciphertexts (inputs + accumulators)
    work_cts   : transient ciphertext-sized temporaries in flight
    """
    total = (n_rot_keys + (1 if relin else 0)) * ksk_bytes(ctx)
    total += (n_cts + work_cts) * ct_bytes(ctx, 0)
    return total


def check_phase(ctx, n_rot_keys: int, n_cts: int, *, relin: bool = True,
                work_cts: int = 4, capacity_gb: float | None = None,
                headroom_frac: float = DEFAULT_HEADROOM_FRAC,
                label: str = "phase") -> dict:
    """Account one phase and raise if it cannot fit the device's memory.
    `capacity_gb=None` reads the context's CUDA device."""
    if capacity_gb is None:
        capacity_gb = device_capacity_gb(ctx)
    used = phase_bytes(ctx, n_rot_keys, n_cts, relin=relin, work_cts=work_cts)
    budget = capacity_gb * (1 - headroom_frac) * (1 << 30)
    report = {
        "label": label,
        "ksk_mb": round(ksk_bytes(ctx) / (1 << 20), 1),
        "ct_mb": round(ct_bytes(ctx, 0) / (1 << 20), 1),
        "n_rot_keys": n_rot_keys,
        "n_cts": n_cts,
        "used_gb": round(used / (1 << 30), 2),
        "budget_gb": round(budget / (1 << 30), 2),
        "fits": used <= budget,
    }
    if not report["fits"]:
        raise MemoryError(
            f"device memory budget: {label} needs {report['used_gb']} GB "
            f"({n_rot_keys} rot keys x {report['ksk_mb']} MB + "
            f"{n_cts}+{work_cts} cts x {report['ct_mb']} MB) "
            f"> {report['budget_gb']} GB available "
            f"({capacity_gb:.1f} GB on the device - {headroom_frac:.0%} headroom)")
    return report
