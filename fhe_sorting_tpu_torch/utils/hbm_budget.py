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
  * the butterfly NTT's twiddle tables and the plans are O(limbs * n) once
    per context and lie inside the measured working sets below (every
    `WORK_CTS` term was fitted on a butterfly context); the four-step NTT's
    tables of a K1 context, int64 and the kernel's copy, are larger (1.6
    GiB over 115 primes at ring 2^17) and are counted itself
    (`ntt_table_bytes`).

The capacity is the context device's own (`torch.cuda.get_device_properties`);
on the CPU there is none to ask, and the caller passes `capacity_gb`.  Every
size is in binary units (GiB, MiB), the capacity too.

Each path reckons its keys and long-lived ciphertexts by count, and what its
ops hold in flight as `WORK_CTS[path]` top-level ciphertexts, measured on the
card.  A staged path on CUDA graphs (`parallel/whole_graph.py`) has terms of
its own (`work_cts(path, graphs=True)`): its graphs' fixed input buffers,
their outputs and their shared memory pool stay allocated beside the keys,
and its peak is taken over the first sort, which runs each stage eagerly and
then captures it.  After it runs, `check_peak` holds the measured peak to
the budget.

The gather-free automorphism (`core/auto_affine.py`, on where
`Evaluator.use_affine` is) adds its tables, eight [L, n2, n2] planes of 8
bytes over every prime of the chain (`affine_table_bytes`), and the
working set of its products (`WORK_CTS["affine"]`): `check_phase(...,
affine=True)`.
"""

from __future__ import annotations

from dataclasses import fields

import torch

from ..core.ntt_mxu import FourStepTables, split_n

RESIDUE_BYTES = torch.empty((), dtype=torch.int64).element_size()
# left for the caching allocator's slack, key-switch temporaries ([dnum, Lq+K,
# n] extended digits) and the context's tables
DEFAULT_HEADROOM_FRAC = 0.20
# A path's working set: the ciphertexts its ops hold in flight beyond the
# long-lived ones it counts, in top-level ciphertexts of its chain, from a
# peak measured on an H100 80GB HBM3 at 700 W at the path's largest
# configuration: (peak - resident keys - long-lived cts) / ct_bytes(ctx, 0),
# rounded up.
WORK_CTS = {
    # DirectSort N=1024 staged, 27.10 GiB: 10 keys x 0.674 + 4 cts x 0.168 GiB
    # (`large_sort --n 1024 --path staged`)
    "direct_staged": 118,
    # N=1024 per-op, 8 lazy keys, 26.55 GiB: 9 keys, 8 cts (`large_sort`)
    "direct_per_op": 114,
    # staged hybrid N=512, 18.50 GiB: 11 keys x 1.172 + 4 cts x 0.195 GiB
    # (`chip_smoke.py` phase 12)
    "hybrid_staged": 25,
    # MEHP24 N=64, 35.52 GiB: 44 keys x 0.703 + 6 cts x 0.176 GiB (phase 10)
    "mehp24": 21,
    # staged MEHP24 N=512, 21.91 GiB: 17 keys x 0.9375 + 12 cts x 0.1875 GiB
    # (phase 12)
    "mehp24_staged": 20,
    # a uniform-secret refresh (BSGS babies, key-switch digits, the EvalMod
    # powers): 18.3 GiB beside the keys and the k-way network's ciphertexts
    # at depth 42, 110 x 176 MiB rounded up (phase 11)
    "bootstrap": 110,
    # The two sharded terms were fitted to the first run of `chip_smoke.py`
    # phase 13, the run their reckoning then checks: there it restates that
    # run and predicts nothing.
    # sharded DirectSort N=1024 on one rank, 45.19 GiB: 20 rotation + 16
    # offset keys + relin = 37 keys x 0.674 + 4 cts x 0.168 GiB
    "direct_sharded": 117,
    # sharded MEHP24 N=512 on one rank, 50.72 GiB: 47 rotation keys (the
    # 48 steps of `rotation_indices_mehp24(256)`, +-2^15 one galois element)
    # + relin = 48 keys x 0.9375 + 12 cts x 0.1875 GiB
    "mehp24_sharded": 19,
    # -- on CUDA graphs (`parallel/whole_graph.py`): the peak over a warm-up
    # sort (each stage run eagerly, then captured) and a sort of replays, from
    # each path's first runs on an H100 80GB HBM3 at 700 W.  The warm-up
    # holds the most: a stage's eager working set, then its capture's in the
    # graphs' pool, beside every earlier graph's buffers and outputs.
    # DirectSort N=1024 staged, 29.82 GiB in the warm-up (14.85 replaying):
    # 10 keys x 0.674 + 4 cts x 0.168 GiB (`large_sort --n 1024 --path staged`).
    # On a K1 context the same sort (`utils/bench.py`) peaked at 30.95 GiB,
    # within the 31.50 GiB reckoned with its 1.59 GiB of four-step tables
    # (`ntt_table_bytes`)
    "direct_staged_graphs": 134,
    # staged hybrid N=512, 20.12 GiB: 11 keys x 1.172 + 8 cts x 0.195 GiB
    # (`chip_smoke.py` phase 12)
    "hybrid_staged_graphs": 30,
    # staged MEHP24 N=512, 25.61 GiB: 17 keys x 0.9375 + 12 cts x 0.1875 GiB
    # (phase 12)
    "mehp24_staged_graphs": 40,
    # ScanDirectSort N=128 at ring 2^17, 15.56 GiB in the warm-up: 10 keys x
    # 0.533 + 4 cts x 0.133 GiB (phase 14's sort, on its own keys)
    "direct_scan_graphs": 74,
    # -- beside a path's own term where the automorphism is the affine path's
    # (`check_phase(..., affine=True)`): the float64 intermediates of its
    # products.  The staged N=128 sort on the affine path peaked 2.38 GiB
    # above the same sort by the gather eagerly and 2.37 GiB on graphs
    # (`chip_smoke.py` phase 15 against phase 5's sorts, on an H100 80GB
    # HBM3 at 700 W); less the 1.42 GiB of tables, 7.2 x 0.133 GiB rounded up
    "affine": 8,
}


def affine_table_bytes(ctx) -> int:
    """The affine automorphism's tables (`Context.auto_tables`) in bytes:
    `fb`, `fib` and `wneg` as int64 residues and their five float64 forms,
    each [L, n2, n2] over every prime of the chain, and the primes."""
    n2 = split_n(ctx.params.ring_n)[1]
    return (8 * n2 * n2 + 1) * (ctx.num_q + ctx.num_sp) * RESIDUE_BYTES


def affine_bytes(ctx) -> int:
    """What the affine automorphism adds to a phase: its tables and the
    working set of its products."""
    return affine_table_bytes(ctx) + WORK_CTS["affine"] * ct_bytes(ctx, 0)


def ntt_table_bytes(ctx) -> int:
    """The four-step NTT's tables of a K1 context in bytes: the int64
    tables and the kernel's copy (`ntt_mxu.FourStepTables`); 0 on a
    butterfly context."""
    t = ctx.tables
    if not isinstance(t, FourStepTables):
        return 0
    own = sum(getattr(t, f.name).numel() * getattr(t, f.name).element_size()
              for f in fields(t) if f.name != "kern")
    return own + (t.kern.nbytes() if t.kern is not None else 0)


def work_cts(path: str, graphs: bool) -> int:
    """`WORK_CTS` of a path, on CUDA graphs or eager."""
    return WORK_CTS[f"{path}_graphs" if graphs else path]


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
                work_cts: int = 4, affine: bool = False) -> int:
    """Resident bytes for one execution phase.

    n_rot_keys : rotation keys resident during the phase
    n_cts      : long-lived ciphertexts (inputs + accumulators)
    work_cts   : transient ciphertext-sized temporaries in flight
    affine     : the automorphism is the affine path's (its tables and the
                 working set of its products)
    The four-step NTT's tables of a K1 context are always counted.
    """
    total = ntt_table_bytes(ctx) + (n_rot_keys + (1 if relin else 0)) * ksk_bytes(ctx)
    total += (n_cts + work_cts) * ct_bytes(ctx, 0)
    if affine:
        total += affine_bytes(ctx)
    return total


def check_phase(ctx, n_rot_keys: int, n_cts: int, *, relin: bool = True,
                work_cts: int = 4, affine: bool = False, capacity_gb: float | None = None,
                headroom_frac: float = DEFAULT_HEADROOM_FRAC,
                label: str = "phase") -> dict:
    """Account one phase and raise if it cannot fit the device's memory.
    `capacity_gb=None` reads the context's CUDA device."""
    if capacity_gb is None:
        capacity_gb = device_capacity_gb(ctx)
    used = phase_bytes(ctx, n_rot_keys, n_cts, relin=relin, work_cts=work_cts, affine=affine)
    budget = capacity_gb * (1 - headroom_frac) * (1 << 30)
    report = {
        "label": label,
        "ksk_mib": round(ksk_bytes(ctx) / (1 << 20), 1),
        "ct_mib": round(ct_bytes(ctx, 0) / (1 << 20), 1),
        "n_rot_keys": n_rot_keys,
        "n_cts": n_cts,
        "work_cts": work_cts,
        "ntt_tables_gib": round(ntt_table_bytes(ctx) / (1 << 30), 2),
        "affine_gib": round(affine_bytes(ctx) / (1 << 30), 2) if affine else 0.0,
        "used_gib": round(used / (1 << 30), 2),
        "budget_gib": round(budget / (1 << 30), 2),
        "fits": used <= budget,
    }
    if not report["fits"]:
        raise MemoryError(
            f"device memory budget: {label} needs {report['used_gib']} GiB "
            f"({n_rot_keys} rot keys x {report['ksk_mib']} MiB + "
            f"{n_cts}+{work_cts} cts x {report['ct_mib']} MiB) "
            f"> {report['budget_gib']} GiB available "
            f"({capacity_gb:.1f} GiB on the device - {headroom_frac:.0%} headroom)")
    return report


def check_peak(report: dict, peak_gib: float) -> None:
    """Raise where a measured peak of device memory (GiB) exceeds the
    budget `report` (from `check_phase`) was reckoned against."""
    if peak_gib > report["budget_gib"]:
        raise MemoryError(f"{report['label']}: peak device memory {peak_gib:.2f} GiB exceeds "
                          f"the {report['budget_gib']} GiB budget of the reckoning "
                          f"({report['used_gib']} GiB reckoned)")
