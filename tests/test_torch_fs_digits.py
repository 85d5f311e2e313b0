"""K1's arithmetic (`csrc/fs_ntt.cu`) as a numpy transcription, on the CPU.

The CUDA kernel cannot run without a card (tests/test_torch_kernels.py holds
it against the plain version there).  What runs here is exactly what it
computes: the balanced s8 digit split with its byte transpose, the seven
group sums in int32, and the signed recombination to a canonical residue,
with every intermediate held to the width the kernel's source note proves.
All comparisons are exact (tolerance 0): against `mod_matmul` and against
Python integers."""

import numpy as np
import pytest
import torch

from fhe_sorting_tpu_torch.core import ntt_mxu
from fhe_sorting_tpu_torch.core import primes as tprimes

BIAS = 0x80808080
M32 = 0xFFFFFFFF


def _split(v):
    """u32 residues [...] -> the word whose byte i is digit i (as s8)."""
    t = v.astype(np.uint64) + BIAS
    assert (t <= M32).all()                       # the add never leaves 32 bits
    return (t ^ BIAS).astype(np.uint32)


def _digits(v):
    """[...] residues -> int8 [4, ...] balanced digits, through `_split`."""
    w = _split(v)
    return np.stack([((w >> (8 * i)) & 0xFF).astype(np.uint8).view(np.int8) for i in range(4)])


def _digits_by_carry(v):
    """The digit-by-digit carry rule of the TPU kernel (`_digits_bf16`)."""
    v = v.astype(np.int64)
    out = []
    for _ in range(4):
        b = v & 0xFF
        d = b - np.where(b >= 128, 256, 0)
        out.append(d.astype(np.int8))
        v = (v - d) >> 8
    assert (v == 0).all()
    return np.stack(out)


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte j of the result is byte sel[j] of (x | y << 32)."""
    src = x.astype(np.uint64) | (y.astype(np.uint64) << 32)
    out = np.zeros_like(src)
    for j in range(4):
        out |= ((src >> (8 * ((sel >> (4 * j)) & 7))) & 0xFF) << (8 * j)
    return out.astype(np.uint32)


def _pack4(w):
    """The kernel's 4 x 4 byte transpose: w [4] words of four consecutive k
    -> [4] words, word i holding digit i of those four k in order."""
    t0, t1 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[0], w[1], 0x7362)
    t2, t3 = _byte_perm(w[2], w[3], 0x5140), _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _group_sums(da, db):
    """S_k = sum_{i+j=k} A_i @ B_j as the s32 accumulators hold them."""
    K = da.shape[-1]
    s = np.zeros((7,) + da.shape[1:-1] + db.shape[2:], dtype=np.int64)
    for i in range(4):
        for j in range(4):
            s[i + j] += da[i].astype(np.int64) @ db[j].astype(np.int64)
    assert np.abs(s).max() <= 4 * K * 128 * 128 <= 2**25      # the source note's bound
    assert np.abs(s).max() < 2**31
    return s.astype(np.int32)


def _mod_consts(p):
    r32 = (1 << 32) % p
    return dict(p=p, p2=2 * p, r32=r32, r32sh=(r32 << 32) // p, m52=(1 << 52) // p,
                offl=((1 << 50) // p + 1) * p, offh=((1 << 42) // p + 1) * p)


def _red52(x, c):
    assert (x < (1 << 52)).all()
    q = ((x >> np.uint64(20)) * np.uint64(c["m52"])) >> np.uint64(32)
    assert c["m52"] <= M32 and (q <= M32).all()
    r = x - q * np.uint64(c["p"])                     # exact: q never exceeds the quotient
    assert (r < 3 * c["p"]).all()
    wrapped = ((x & np.uint64(M32)) - ((q * np.uint64(c["p"])) & np.uint64(M32))) & np.uint64(M32)
    assert (wrapped == r).all()                       # the kernel computes it in 32 bits
    return r


def _recombine(s, p):
    """sum_k S_k 256^k mod p as `recombine` does, widths asserted."""
    c = _mod_consts(p)
    s = s.astype(np.int64)
    low = s[0] + s[1] * 256 + s[2] * 65536 + s[3] * 16777216
    high = s[4] + s[5] * 256 + s[6] * 65536
    assert np.abs(low).max() < 2**50 and np.abs(high).max() < 2**42
    xh, xl = high + c["offh"], low + c["offl"]
    assert xh.min() >= 0 and xl.min() >= 0
    h = _red52(xh.astype(np.uint64), c)
    hr = h * np.uint64(c["r32"]) - ((h * np.uint64(c["r32sh"])) >> np.uint64(32)) * np.uint64(p)
    assert (hr < 2 * p).all()
    lo = _red52(xl.astype(np.uint64), c)
    lo = np.where(lo >= 2 * p, lo - np.uint64(2 * p), lo)
    v = hr + lo
    assert (v < 4 * p).all() and 4 * p <= 1 << 32
    v = np.where(v >= 2 * p, v - np.uint64(2 * p), v)
    v = np.where(v >= p, v - np.uint64(p), v)
    return v.astype(np.int64)


def _model_matmul(a, b, p):
    """(a @ b) mod p for residue matrices a [M, K], b [K, N], as the kernel."""
    return _recombine(_group_sums(_digits(a), _digits(b.T.copy()).transpose(0, 2, 1)), p)


def _edge_primes(K):
    """Smallest and largest prime of the four-step range at depth K."""
    lo = 4 * 128 * 128 * K + 1
    while not tprimes.is_prime(lo):
        lo += 1
    hi = 2**30 - 1
    while not tprimes.is_prime(hi):
        hi -= 1
    return lo, hi


def _operands(kind, p, M, K, N, rng):
    if kind == "random":
        return (rng.integers(0, p, (M, K), dtype=np.int64),
                rng.integers(0, p, (K, N), dtype=np.int64))
    if kind == "p-1":
        return np.full((M, K), p - 1, dtype=np.int64), np.full((K, N), p - 1, dtype=np.int64)
    # the largest residue whose low digits (three, where p has room) are all -128
    nd = 3 if p > 2**25 else 2
    low = 128 * sum(256**i for i in range(nd))
    v = ((p - 1 + low) >> (8 * nd) << (8 * nd)) - low
    assert 0 <= v < p and (_digits(np.array([v]))[:nd, 0] == -128).all()
    return np.full((M, K), v, dtype=np.int64), np.full((K, N), v, dtype=np.int64)


def test_split_is_the_carry_rule_and_packs_by_digit():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.integers(0, 2**30, 4096), [0, 1, 127, 128, 255, 256, 0x7F7F7F7F >> 1,
                                                       0x3F808080, 2**30 - 1, 0x00808080]])
    d = _digits(v)
    np.testing.assert_array_equal(d, _digits_by_carry(v))
    np.testing.assert_array_equal(sum(d[i].astype(np.int64) << (8 * i) for i in range(4)), v)
    # the port's table builder splits the same way
    dt = ntt_mxu.digit_planes(torch.from_numpy(v.astype(np.int64)).reshape(1, 1, -1))
    np.testing.assert_array_equal(dt[0, :, 0].numpy(), d)
    # four consecutive k -> one word per digit, lowest k in the lowest byte
    w = _split(v[:4096]).reshape(-1, 4).T
    for i, word in enumerate(_pack4(list(w))):
        got = np.stack([((word >> (8 * e)) & 0xFF).astype(np.uint8).view(np.int8)
                        for e in range(4)], axis=1)
        np.testing.assert_array_equal(got, d[i, :4096].reshape(-1, 4))


@pytest.mark.parametrize("kind", ["random", "p-1", "low digits -128"])
@pytest.mark.parametrize("which", ["smallest", "largest"])
@pytest.mark.parametrize("K", [64, 256, 512])
def test_model_matmul_matches_mod_matmul_and_integers(K, which, kind):
    p = _edge_primes(K)[which == "largest"]
    M, N = 6, 5
    a, b = _operands(kind, p, M, K, N, np.random.default_rng(K))
    got = _model_matmul(a, b, p)
    want = ntt_mxu.mod_matmul(torch.from_numpy(a), torch.from_numpy(b), torch.tensor(p))
    np.testing.assert_array_equal(got, want.numpy())
    exact = [[sum(int(a[i, k]) * int(b[k, j]) for k in range(K)) % p for j in range(N)]
             for i in range(M)]
    np.testing.assert_array_equal(got, np.array(exact))


@pytest.mark.parametrize("K", [64, 256, 512])
@pytest.mark.parametrize("da,db", [(-128, -128), (-128, 127), (127, 127)])
def test_group_sums_at_the_digit_extremes(K, da, db):
    """Digit planes filled with one extreme digit: the group sums reach the
    bound the accumulators are proved for, and the recombination still equals
    the integer it stands for."""
    a = np.full((4, 3, K), da, dtype=np.int8)
    b = np.full((4, K, 2), db, dtype=np.int8)
    s = _group_sums(a, b)
    assert abs(int(s[3, 0, 0])) == 4 * K * abs(da * db)
    for p in _edge_primes(K):
        want = sum(int(s[k, 0, 0]) << (8 * k) for k in range(7)) % p
        np.testing.assert_array_equal(_recombine(s, p), np.full((3, 2), want))


@pytest.mark.parametrize("n", [1 << 12, 1 << 14])
def test_kernel_tables_recombine_to_the_int64_tables(n):
    ps = tprimes.ntt_primes(n, 28, 2)
    t = ntt_mxu.build_fs_tables(ps, n, "cpu")
    assert t.kern is None                      # made only where the kernel runs
    k = ntt_mxu.build_kernel_tables(t)
    n1, n2 = ntt_mxu.split_n(n)
    for name, rows in (("w1f", n1), ("w1i", n1), ("w2f", n2), ("w2i", n2)):
        planes = getattr(k, name)
        tile = 128 if rows % 128 == 0 else 64
        assert planes.dtype == torch.int8 and planes.is_contiguous()
        assert planes.shape == (2, rows // tile, rows // 64, 4, tile, 80)
        assert not planes[..., 64:].any()          # the rows' padding
        back = ntt_mxu.from_tiled_digit_planes(planes)
        if name.startswith("w2"):
            back = back.transpose(1, 2)        # right operands are stored K-contiguous
        assert torch.equal(back, getattr(t, name))
    for name in ("tf", "ti"):
        packed = getattr(k, name)
        assert torch.equal(packed & M32, getattr(t, name))
        assert torch.equal((packed >> 32) & M32, getattr(t, name + "_sh"))
    # a product through the kernel-side planes is the plain product
    x = torch.from_numpy(np.random.default_rng(n).integers(0, ps[0], (n1, n2), dtype=np.int64))
    da = ntt_mxu.digit_planes(t.w1f)[0].numpy()
    assert torch.equal(ntt_mxu.from_tiled_digit_planes(k.w1f), ntt_mxu.from_digit_planes(
        ntt_mxu.digit_planes(t.w1f)))
    got = _recombine(_group_sums(da, _digits(x.numpy().T.copy()).transpose(0, 2, 1)), ps[0])
    np.testing.assert_array_equal(got, ntt_mxu.mod_matmul(t.w1f[0], x, t.p[0]).numpy())
    assert k.nbytes() == 2 * (4 * 2 * (n1 * n1 + n2 * n2) * 80 // 64 + 2 * 8 * n + 4 * 8)
    # the reduction constants are the ones the model derives from p
    for li, p in enumerate(ps):
        c = _mod_consts(p)
        w = [int(v) & (2**64 - 1) for v in k.mods[li].tolist()]
        assert (w[0] & M32, w[0] >> 32, w[1] & M32, w[1] >> 32, w[2], w[3]) == (
            p, c["r32"], c["r32sh"], c["m52"], c["offl"], c["offh"])
