"""The frozen roofline arithmetic (`portbench/sol.py`)."""

import pytest

from portbench import sol

BENCH_128 = dict(ring_n=1 << 17, mult_depth=32, scale_bits=56, comp=2, base_limbs=4, dnum=3)


def test_forward_ntt_of_two_by_68_limbs_at_ring_2_17():
    """[2, 68, 2^17] at 4-byte residues, read once and written once: 142.6 MB,
    0.043 ms on 3.35 TB/s."""
    planes = 2 * 68
    assert sol.ntt_bytes(planes, 1 << 17) == 136 * 2**17 * 4 * 2
    assert sol.ntt_bytes(planes, 1 << 17) / 1e6 == pytest.approx(142.6, abs=0.05)
    assert sol.ntt_seconds(planes, 1 << 17) * 1e3 == pytest.approx(0.0426, abs=5e-4)


def test_chain_geometry_of_the_direct_cell():
    g = sol.geometry(BENCH_128)
    assert (g["num_q"], g["num_sp"], g["alpha"]) == (68, 23, 23)


@pytest.mark.parametrize("key,planes", [
    # level 0: L=68, D=3 digits over L+K=91, ModDown 2*23 + 2*68
    (("rot", 0), 68 + 3 * 91 + 46 + 136),
    (("mult_ct", 0), 68 + 3 * 91 + 46 + 136),
    # level 31: L=6, one digit over 29
    (("rot", 31), 6 + 29 + 46 + 12),
    (("rot_pre", 0), 68 + 3 * 91),
    (("rot_hoisted", 0), 46 + 136),
    # two dropped limbs at level 0: (2 + 2*67) + (2 + 2*66)
    (("rescale", 0), 136 + 134),
    (("add", 0), 0), (("mult_pt", 3), 0), (("combo", 1, 4, 2), 0),
])
def test_ntt_planes_of_one_op(key, planes):
    assert sol.op_planes(sol.geometry(BENCH_128), key) == planes


def test_tally_weights_each_op_by_its_count():
    tally = {("rot", 0): 3, ("rescale", 0): 2, ("add", 0): 9}
    assert sol.tally_planes(BENCH_128, tally) == 3 * 523 + 2 * 270
