"""The benchmark's frozen roofline arithmetic: the least time the H100 needs for the NTT work.

A residue is priced at 4 bytes: every prime of the chain is below 2^31, so
4 bytes is the least any implementation moves, whatever width the program
holds its residues in.  An NTT plane (one limb of one polynomial, n
residues) is read once and written once; twiddle tables and the program's
own extra passes are not counted, so the bound is one no implementation can
beat.  The peak is NVIDIA's published HBM3 bandwidth of the H100 SXM,
3.35 TB/s (at its 700 W power limit).

The planes are the NTTs the evaluator's ops need, counted from the op
tallies the program keeps for each stage (`(op, level, ...) -> count`), on
the chain geometry the configuration states:

  key switch at level l (`rot`, `mult_ct`): ModUp's inverse transform of
    the L active limbs and forward transforms of D digits over the L + K
    extended limbs, ModDown's inverse of 2K special limbs and forward of
    2L, where L = num_q - comp l, K = ceil(num_q / dnum) special primes,
    D = ceil(L / alpha) digits of alpha = ceil(num_q / dnum) limbs;
  `rot_pre`: ModUp alone; `rot_hoisted`: ModDown alone;
  `rescale` at level l: for each of the comp dropped limbs j, the inverse
    transform of the dropped limb of both polynomials and the forward
    transform of the L - j - 1 limbs kept, of both;
  `add`, `mult_pt`, `combo`: none.

A rescale that an op performs inside itself (a ct-ct product of inputs at
scale degree 2) is not in the tallies and is not counted, so the work is a
lower bound.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12          # H100 SXM, HBM3, NVIDIA's data sheet
RESIDUE_BYTES = 4


def geometry(params: dict) -> dict:
    """num_q, num_sp (K) and alpha of the chain the configuration states."""
    num_q = params["comp"] * params["mult_depth"] + params["base_limbs"]
    alpha = -(-num_q // params["dnum"])
    return dict(num_q=num_q, num_sp=alpha, alpha=alpha, comp=params["comp"],
                depth=params["mult_depth"])


def _limbs(g: dict, level: int) -> int:
    return g["num_q"] - g["comp"] * min(level, g["depth"])


def modup_planes(g: dict, level: int) -> int:
    L = _limbs(g, level)
    return L + -(-L // g["alpha"]) * (L + g["num_sp"])


def moddown_planes(g: dict, level: int) -> int:
    return 2 * g["num_sp"] + 2 * _limbs(g, level)


def op_planes(g: dict, key: tuple) -> int:
    """NTT planes (forward and inverse) one op of the tally key needs."""
    op, level = key[0], key[1]
    if op in ("rot", "mult_ct"):
        return modup_planes(g, level) + moddown_planes(g, level)
    if op == "rot_pre":
        return modup_planes(g, level)
    if op == "rot_hoisted":
        return moddown_planes(g, level)
    if op == "rescale":
        L = _limbs(g, level)
        return sum(2 + 2 * (L - j - 1) for j in range(g["comp"]))
    return 0


def tally_planes(params: dict, tally: dict) -> int:
    """NTT planes of every op in an op tally {key: count}."""
    g = geometry(params)
    return sum(op_planes(g, tuple(k)) * c for k, c in tally.items())


def ntt_bytes(planes: int, ring_n: int) -> float:
    """Each plane's residues read once and written once, at 4 bytes."""
    return 2.0 * planes * ring_n * RESIDUE_BYTES


def ntt_seconds(planes: int, ring_n: int) -> float:
    """The least time the H100 can take for `planes` NTT planes."""
    return ntt_bytes(planes, ring_n) / HBM_BYTES_S


# the program's NTT kernels, by a part of their names in the device trace:
# K1 (the four-step NTT, `csrc/fs_ntt.cu`) and K2 (the butterfly NTT,
# `csrc/bf_ntt.cu`)
NTT_KERNELS = ("modmm_kernel", "bf_cluster_kernel")
