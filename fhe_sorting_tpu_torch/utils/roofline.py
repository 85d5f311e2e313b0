"""Speed-of-light accounting for the core FHE kernels on one NVIDIA H100.

Port of `fhe_sorting_tpu/utils/roofline.py`: the bytes each kernel moves
through device memory and the work it does, from (ring_n, limbs, key-switch
geometry), and a measured wall-clock as a share of the least time the card
could take.  Names and formulas are the reference's, with three changes,
each stated where it applies:

  * a residue is `hbm_budget.RESIDUE_BYTES` (8) bytes, an int64 plane, where
    the reference counts 4 (u32); every cost function takes `rb`;
  * `ntt_butterfly` is K2's one pass through device memory a transform
    (data in and out and the limbs' twiddle table), where the reference
    charges log2(n) passes of its XLA lowering (`passes=` keeps that form);
  * the butterfly NTT's bound is the function's (`chip_smoke._ntt_bound`
    calls this module): 0.106 ms for a forward NTT of [2, 68, 2^17] on
    `H100`, by bytes.

Work is counted in three kinds: device-memory bytes, tensor-core MACs (the
four-step NTT's and the base extensions' s8 digit products, as the
reference counts them for the MXU) and 32-bit integer operations on the
CUDA cores (the butterfly NTT's).  A cost's speed of light is the largest
of the three times.
"""

from __future__ import annotations

from dataclasses import dataclass

from .hbm_budget import RESIDUE_BYTES


@dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_bytes_s: float
    mxu_macs_s: float            # tensor-core (MXU) multiply-adds a second
    int_ops_s: float             # 32-bit integer operations a second outside them
    mxu_name: str = "MXU"
    fp64_flops_s: float = 0.0    # float64 operations a second (0: not rated)


# NVIDIA's data sheet for the H100 SXM at its 700 W power limit, dense rates:
# HBM3 3.35 TB/s; int8 tensor cores 1979 T op/s = 989.5 T MAC/s; 67 T op/s of
# float32 on the CUDA cores (a multiply-add counted as two), the rate taken
# for 32-bit integer work, for which no rate of its own is published; 67 T
# float64 op/s on the tensor cores (the float64 products of the affine
# automorphism, `utils/auto_microbench.py`).
H100 = ChipSpec("H100 SXM (700 W)", hbm_bytes_s=3.35e12, mxu_macs_s=989.5e12,
                int_ops_s=67e12, mxu_name="tensor cores", fp64_flops_s=67e12)
# the reference's default chip, kept to hold this module to the reference:
# the reference folds its VPU work into the HBM bound, so nothing here is
# charged to `int_ops_s`
V5E = ChipSpec("v5e", hbm_bytes_s=819e9, mxu_macs_s=197e12, int_ops_s=7e12)


@dataclass
class KernelCost:
    """Device-memory bytes, tensor-core MACs and CUDA-core integer
    operations of one kernel invocation."""

    name: str
    bytes_hbm: float
    macs_mxu: float
    int_ops: float = 0.0

    def _times(self, chip: ChipSpec) -> dict:
        return {"HBM": self.bytes_hbm / chip.hbm_bytes_s,
                chip.mxu_name: self.macs_mxu / chip.mxu_macs_s,
                "CUDA cores": self.int_ops / chip.int_ops_s}

    def sol_seconds(self, chip: ChipSpec = H100) -> float:
        """Speed of light: the largest of the memory, tensor-core and
        integer times."""
        return max(self._times(chip).values())

    def pct_of_sol(self, measured_s: float, chip: ChipSpec = H100) -> float:
        return 100.0 * self.sol_seconds(chip) / max(measured_s, 1e-12)

    def bound(self, chip: ChipSpec = H100) -> str:
        """Which unit sets the speed of light ("HBM" on a tie)."""
        times = self._times(chip)
        return max(times, key=times.get)


def ntt_fourstep(n: int, limbs: int, polys: int = 1, rb: int = RESIDUE_BYTES) -> KernelCost:
    """Four-step NTT (K1, `csrc/fs_ntt.cu`): one read and one write of the
    data block per (limb, poly); the twiddle matrices are read once per
    limb.  Tensor-core work: two [n1,n1]x[n1,n2]-shaped digit matmuls of 16
    s8 digit-pair products each."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    data = polys * limbs * n * rb
    twiddles = limbs * (n1 * n1 + n2 * n2 + 2 * n1 * n2) * rb
    macs = polys * limbs * 16 * (n1 * n1 * n2 + n1 * n2 * n2)
    return KernelCost("ntt_fourstep", data * 2 + twiddles, macs)


def ntt_butterfly(n: int, limbs: int, polys: int = 1, rb: int = RESIDUE_BYTES,
                  passes: int | None = None) -> KernelCost:
    """Butterfly NTT.  `passes=None` is K2 (`csrc/bf_ntt.cu`): one pass a
    transform, the data read and written once and the limbs' [limbs, n]
    twiddle table read once; (n/2) log2(n) butterflies a plane, ten 32-bit
    integer operations each (a product, its two-step reduction, an add and
    a subtract with their corrections).  An integer `passes` is the
    reference's form: that many full passes of the data and nothing else
    (its XLA lowering takes log2(n))."""
    data = polys * limbs * n * rb
    if passes is not None:
        return KernelCost("ntt_butterfly", data * 2 * passes, 0)
    ops = 10.0 * polys * limbs * (n // 2) * (n.bit_length() - 1)
    return KernelCost("ntt_butterfly", data * 2 + limbs * n * rb, 0, ops)


def _ntt(kind: str, n: int, limbs: int, rb: int) -> KernelCost:
    return ntt_butterfly(n, limbs, rb=rb) if kind == "butterfly" else ntt_fourstep(n, limbs, rb=rb)


def keyswitch(n: int, limbs: int, num_sp: int, dnum_active: int, alpha: int,
              rb: int = RESIDUE_BYTES, ntt: str = "fourstep") -> KernelCost:
    """Hybrid key switch of one [limbs, n] polynomial:
       ModUp: per digit INTT(alpha) + base-extension matmul [T,alpha]@[alpha,n]
              + NTT(T);  T = limbs + num_sp
       inner product: 2 * dnum * T ct*ksk mulmods (bound by the key's read)
       ModDown x2: INTT(K) + extension matmul [limbs,K]@[K,n] + NTT(limbs)
    `ntt` names the transform the context runs: "fourstep" (K1) or
    "butterfly" (K2)."""
    T = limbs + num_sp
    ntts = [_ntt(ntt, n, dnum_active * alpha, rb),       # ModUp INTTs
            _ntt(ntt, n, dnum_active * T, rb),           # ModUp NTTs
            _ntt(ntt, n, 2 * num_sp, rb),                # ModDown INTTs
            _ntt(ntt, n, 2 * limbs, rb)]                 # ModDown NTTs
    ext_macs = 16 * n * (dnum_active * T * alpha + 2 * limbs * num_sp)
    ksk_bytes = 2 * dnum_active * T * n * rb
    ip_bytes = ksk_bytes + 2 * T * n * rb * 2
    return KernelCost("keyswitch", sum(k.bytes_hbm for k in ntts) + ip_bytes + ext_macs / 64,
                      sum(k.macs_mxu for k in ntts) + ext_macs,
                      sum(k.int_ops for k in ntts))


def ct_mult(n: int, limbs: int, num_sp: int, dnum_active: int, alpha: int,
            rb: int = RESIDUE_BYTES, ntt: str = "fourstep") -> KernelCost:
    """ct x ct mult + relinearisation: 4 elementwise limb products (each
    reads two planes and writes one) + one key switch."""
    ks = keyswitch(n, limbs, num_sp, dnum_active, alpha, rb, ntt)
    elem = 4 * 3 * limbs * n * rb
    return KernelCost("ct_mult", ks.bytes_hbm + elem, ks.macs_mxu, ks.int_ops)


def rescale(n: int, limbs: int, comp: int, rb: int = RESIDUE_BYTES,
            ntt: str = "fourstep") -> KernelCost:
    """comp chained single-prime drops: INTT(1) + NTT(L-j-1) + 2 elementwise
    passes per drop, on 2 polys."""
    b = m = ops = 0.0
    for j in range(comp):
        L = limbs - j
        k1 = _ntt(ntt, n, 2 * 1, rb)
        k2 = _ntt(ntt, n, 2 * (L - 1), rb)
        b += k1.bytes_hbm + k2.bytes_hbm + 3 * 2 * (L - 1) * n * rb
        m += k1.macs_mxu + k2.macs_mxu
        ops += k1.int_ops + k2.int_ops
    return KernelCost("rescale", b, m, ops)


def modup(n: int, limbs: int, num_sp: int, dnum_active: int, alpha: int,
          rb: int = RESIDUE_BYTES, ntt: str = "fourstep") -> KernelCost:
    """Hoisted-rotation precompute: per digit INTT(alpha) + base-extension
    matmul + NTT(T) (the ModUp half of `keyswitch`)."""
    T = limbs + num_sp
    k1 = _ntt(ntt, n, dnum_active * alpha, rb)
    k2 = _ntt(ntt, n, dnum_active * T, rb)
    ext_macs = 16 * n * dnum_active * T * alpha
    return KernelCost("modup", k1.bytes_hbm + k2.bytes_hbm + ext_macs / 64,
                      k1.macs_mxu + k2.macs_mxu + ext_macs, k1.int_ops + k2.int_ops)


def elementwise(n: int, limbs: int, polys: int = 2, passes: float = 3.0,
                rb: int = RESIDUE_BYTES) -> KernelCost:
    """A limb-plane op bound by memory (add, mult by a plaintext or a
    scalar): read and write passes."""
    return KernelCost("elementwise", passes * polys * limbs * n * rb, 0)


def combo_cost(n: int, limbs: int, B: int, R: int, rb: int = RESIDUE_BYTES) -> KernelCost:
    """Batched linear combination (`Evaluator.combo`): read B cts + digit
    temporaries, write R results; 16 digit-pair [R,B]@[B,2n] matmuls per
    limb."""
    data = (2 * B + 2 * R) * 2 * limbs * n * rb
    macs = 16 * limbs * R * B * 2 * n
    return KernelCost("combo", data, macs)


def _op_costs(ctx, op_stats, rb: int):
    """(op kind, cost of one op, count) for each entry of an op tally; the
    NTT is the context's: K2's cost on a butterfly context, K1's otherwise."""
    n = ctx.params.ring_n
    comp = ctx.params.comp
    ntt = "butterfly" if ctx.ntt_impl == "butterfly" else "fourstep"
    for key, cnt in op_stats.items():
        op, lvl = key[0], key[1]
        lvl = min(lvl, ctx.params.mult_depth)
        L, K, D, alpha = ks_geometry(ctx, lvl)
        if op == "mult_ct":
            yield op, ct_mult(n, L, K, D, alpha, rb, ntt), cnt
        elif op in ("rot", "rot_hoisted"):
            ks = keyswitch(n, L, K, D, alpha, rb, ntt)
            yield op, KernelCost(op, ks.bytes_hbm + 3 * 2 * L * n * rb, ks.macs_mxu,
                                 ks.int_ops), cnt
        elif op == "rot_pre":
            yield op, modup(n, L, K, D, alpha, rb, ntt), cnt
        elif op == "rescale":
            yield op, rescale(n, L, comp, rb, ntt), cnt
        elif op in ("mult_pt", "add"):
            yield op, elementwise(n, L, rb=rb), cnt
        elif op == "combo":
            _, _, B, R = key
            yield op, combo_cost(n, L, B, R, rb), cnt


def accumulate_sol(ctx, op_stats, chip: ChipSpec = H100, rb: int = RESIDUE_BYTES):
    """Sum speed-of-light seconds over an `Evaluator.op_stats` counter (or a
    `StagedDirectSort.phase_stats()` entry).

    Returns (total_sol_seconds, per-op-kind breakdown dict).  A measured
    wall-clock divided into this bound is its share of the speed of light."""
    total = 0.0
    breakdown: dict = {}
    for kind, cost, count in _op_costs(ctx, op_stats, rb):
        s = cost.sol_seconds(chip) * count
        total += s
        breakdown[kind] = breakdown.get(kind, 0.0) + s
    return total, breakdown


def sol_by_bound(ctx, op_stats, chip: ChipSpec = H100, rb: int = RESIDUE_BYTES) -> dict:
    """The same speed-of-light seconds split by the unit that bounds each
    op: {"HBM": s, chip.mxu_name: s, "CUDA cores": s} (units with a share)."""
    out: dict = {}
    for _, cost, count in _op_costs(ctx, op_stats, rb):
        unit = cost.bound(chip)
        out[unit] = out.get(unit, 0.0) + cost.sol_seconds(chip) * count
    return out


def phase_sol(ctx, phases: dict, chip: ChipSpec = H100, rb: int = RESIDUE_BYTES) -> dict:
    """{phase: (sol_seconds, by op kind, by bound)}: `accumulate_sol` and
    `sol_by_bound` of each op tally in `phases` (for example
    `StagedDirectSort.one_sort_stats()`)."""
    return {ph: (*accumulate_sol(ctx, st, chip, rb), sol_by_bound(ctx, st, chip, rb))
            for ph, st in phases.items()}


def ks_geometry(ctx, level: int):
    """(limbs, num_sp, dnum_active, alpha) for a Context at `level`."""
    L = ctx.limbs_at(level)
    layout = ctx.digit_layout(level)
    alpha = -(-ctx.num_q // ctx.params.dnum)
    return L, ctx.num_sp, len(layout), alpha


def report(name: str, cost: KernelCost, measured_s: float, chip: ChipSpec = H100) -> str:
    sol = cost.sol_seconds(chip)
    return (f"{name}: measured {measured_s*1e3:.2f} ms, SoL {sol*1e3:.2f} ms "
            f"({cost.bound(chip)}-bound) -> {cost.pct_of_sol(measured_s, chip):.1f}% of SoL")
