// K4: the RNS base extension of the key switch, for Hopper (sm_90a): ModUp's
// extension of every digit into the target basis and ModDown's extension of
// the special rows into the active ones, each in one launch.
//
// Replaces no TPU kernel: the JAX package leaves this product to XLA's
// matmul.  It was added because the op census (`utils/profile_sort.py`) found
// ModUp's and ModDown's plain PyTorch chain among the largest users of device
// time: a 64-bit `remainder` by the hat-inverse, four float64 GEMMs over the
// 16-bit halves of both operands (an inner dimension of only 20-24 rows),
// casts back to int64, eight int64 remainder / multiply / add passes and a
// `stack`, so each output residue crossed device memory about 30 times.
//
// The fast base conversion: for batch b and digit d (rows lo .. hi - 1 of x),
//   y_i          = x[b, i] hat_i mod pin_i                       (i in d)
//   out[bD+d, t] = sum_i F[t, i] y_i mod pout_t                  (t < T)
// with every residue canonical and every prime odd and below 2^31.  Both are
// exact in 32-bit arithmetic:
//   * y by Shoup's product with the quotient hat' = floor(hat 2^32 / pin);
//   * the sum in an unsigned 64-bit accumulator, one IMAD.WIDE a term: a
//     product y F is below 2^62, so four of them, added to a folded sum below
//     2^33, stay below 2^64 (y is summed as the integer it is, in [0, pin):
//     another representative mod pin would change the sum mod pout);
//   * after every four terms a fold: acc = hi 2^32 + lo becomes hi c + lo mod
//     p (c = 2^32 mod p) with Shoup's product left in [0, 2p), below 2^33
//     again;
//   * at the end the same identity reduced fully, Barrett's quotient
//     floor(2^32 / p) for lo, and the canonical residue written as int64.
// A block makes its rows' quotients itself (one division each, before its
// loads), so the context keeps no table beyond the primes, the hat-inverses
// and the factor matrix it has.  The outputs are the plain version's
// residues, bit for bit.
//
// What bounds it on this card: its arithmetic.  The top ModUp of a ring-2^17
// chain of 96 limbs (4 digits of 24, T = 120) writes 503 MB and reads 101 MB,
// 0.180 ms at 3.35 TB/s, but also does 1.5e9 multiply-adds (each a 64-bit
// IMAD.WIDE, at half the 32-bit rate) and 0.3e9 folds, which take longer:
// the kernel runs at about 40% of the byte bound (PERF.md).  The
// design keeps the bytes at one pass and the inner loop at multiply-adds:
//   * a block is 128 threads over 256 columns of one digit (blockIdx.z the
//     batch and digit) and up to 128 target rows (blockIdx.x, the fastest,
//     so blocks that read the same input columns run together and hit L2):
//     every target row of the cells' key switches (T <= 120), so each input
//     residue is read once (32-row tiles, which read it four times, took 7%
//     longer at that ModUp);
//   * it reads its columns of the digit's rows once, 16 bytes a thread,
//     multiplies them by their hat-inverses and keeps them as 32-bit values
//     in shared memory; the factors of its target rows go to shared memory
//     as 32-bit values, zero-padded to whole chunks, so the inner loop has no
//     guard;
//   * each thread owns two adjacent columns and sums eight target rows at a
//     time: a chunk's four terms of two columns in registers, each row's
//     four factors one broadcast 16-byte shared load, so the loop is
//     multiply-adds;
//   * a row's two outputs are one 16-byte store, neighbouring threads on
//     neighbouring addresses; x takes batch and row strides and the constants
//     [r, 1] row strides, so views are read in place.
// The fp64 tensor cores gain nothing at an inner dimension of 24; the int8
// ones could take the multiply-adds (both operands split into bytes, four
// int32 sums an output), the lever if the arithmetic is to fall further.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;          // a block: 128 threads, two columns each
constexpr int COLS = 2 * THREADS;     // the columns of a block
constexpr int TT = 128;               // the target rows of a block
constexpr int TG = 8;                 // the target rows a thread sums at once
constexpr int CH = 4;                 // the terms summed between two folds
constexpr int MAX_DIGITS = 64;
constexpr int MAX_SMEM = 232448;      // the shared memory a block may use

struct Digits {
    int count;                        // D
    int lo[MAX_DIGITS + 1];           // digit d is rows lo[d] .. lo[d + 1] - 1 of x
};

// A target row's prime and the constants of its reductions.
struct Row {
    uint32_t p;
    uint32_t c;                       // 2^32 mod p
    uint32_t cs;                      // floor(c 2^32 / p)
    uint32_t m;                       // floor(2^32 / p)
};

// w x mod p, left in [0, 2p), by Shoup's quotient ws = floor(w 2^32 / p),
// for x < 2^32 and w < p < 2^31.
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t x, uint32_t w, uint32_t ws, uint32_t p) {
    return x * w - __umulhi(x, ws) * p;
}

__device__ __forceinline__ uint32_t once(uint32_t r, uint32_t p) { return r >= p ? r - p : r; }

// A value congruent to acc mod p below 2^33: acc = hi 2^32 + lo = hi c + lo.
__device__ __forceinline__ unsigned long long fold(unsigned long long acc, const Row& r) {
    return (unsigned long long)shoup_lazy((uint32_t)(acc >> 32), r.c, r.cs, r.p) + (uint32_t)acc;
}

// acc mod p in [0, p), by the same identity.
__device__ __forceinline__ long long finish(unsigned long long acc, const Row& r) {
    const uint32_t a = once(shoup_lazy((uint32_t)(acc >> 32), r.c, r.cs, r.p), r.p);
    const uint32_t b = once(shoup_lazy((uint32_t)acc, 1u, r.m, r.p), r.p);
    return once(a + b, r.p);
}

__global__ void __launch_bounds__(THREADS, 4) rns_bconv_kernel(
        const int64_t* __restrict__ x, const int64_t* __restrict__ H,
        const int64_t* __restrict__ Pin, const int64_t* __restrict__ F,
        const int64_t* __restrict__ Pout, int64_t* __restrict__ out, const Digits dg, int T,
        int n, long long sxb, long long sxr, long long sh, long long spi, long long sf,
        long long spo) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int z = blockIdx.z, b = z / dg.count, d = z - b * dg.count;
    const int lo = dg.lo[d], w = dg.lo[d + 1] - lo, wp = (w + CH - 1) / CH * CH;
    uint32_t* y_s = reinterpret_cast<uint32_t*>(smem);            // [wp][COLS]
    uint32_t* f_s = y_s + wp * COLS;                              // [TT][wp]
    Row* r_s = reinterpret_cast<Row*>(f_s + TT * wp);             // [TT]
    uint32_t* in_s = reinterpret_cast<uint32_t*>(r_s + TT);       // [w][3]: pin, hat, hat'
    const int t0 = blockIdx.x * TT, tid = threadIdx.x;
    const int j = 2 * (blockIdx.y * THREADS + tid);
    const bool live = j < n;

    // the rows' constants, and the factors, zero beyond w and T
    for (int t = tid; t < TT; t += THREADS) {
        Row r = {0u, 0u, 0u, 0u};
        if (t0 + t < T) {
            const uint32_t p = (uint32_t)__ldg(Pout + (t0 + t) * spo);
            r.p = p;
            r.c = (uint32_t)((1ull << 32) % p);
            r.cs = (uint32_t)(((unsigned long long)r.c << 32) / p);
            r.m = 0xffffffffu / p;
        }
        r_s[t] = r;
    }
    for (int i = tid; i < w; i += THREADS) {
        const uint32_t p = (uint32_t)__ldg(Pin + (lo + i) * spi);
        const uint32_t h = (uint32_t)__ldg(H + (lo + i) * sh);
        in_s[3 * i] = p;
        in_s[3 * i + 1] = h;
        in_s[3 * i + 2] = (uint32_t)(((unsigned long long)h << 32) / p);
    }
    for (int k = tid; k < TT * wp; k += THREADS) {
        const int t = k / wp, i = k - t * wp;
        f_s[k] = t0 + t < T && i < w ? (uint32_t)__ldg(F + (t0 + t) * sf + lo + i) : 0u;
    }
    __syncthreads();

    // the block's columns of the digit's rows, times their hat-inverses
    const int64_t* xb = x + b * sxb + lo * sxr + j;
#pragma unroll 4
    for (int i = 0; i < wp; ++i) {
        uint2 v = make_uint2(0u, 0u);
        if (i < w && live) {
            const longlong2 u = *reinterpret_cast<const longlong2*>(xb + i * sxr);
            const uint32_t p = in_s[3 * i], h = in_s[3 * i + 1], hs = in_s[3 * i + 2];
            v = make_uint2(once(shoup_lazy((uint32_t)u.x, h, hs, p), p),
                           once(shoup_lazy((uint32_t)u.y, h, hs, p), p));
        }
        *reinterpret_cast<uint2*>(y_s + i * COLS + 2 * tid) = v;
    }
    __syncthreads();
    if (!live) return;

    // the sums, TG target rows at a time
    int64_t* o = out + (long long)z * T * n + j;
    for (int g = 0; g < TT && t0 + g < T; g += TG) {
        unsigned long long acc[TG][2];
#pragma unroll
        for (int k = 0; k < TG; ++k) acc[k][0] = acc[k][1] = 0;
        for (int c = 0; c < wp; c += CH) {
            uint2 y[CH];
#pragma unroll
            for (int i = 0; i < CH; ++i)
                y[i] = *reinterpret_cast<const uint2*>(y_s + (c + i) * COLS + 2 * tid);
#pragma unroll
            for (int k = 0; k < TG; ++k) {
                const uint4 fv = *reinterpret_cast<const uint4*>(f_s + (g + k) * wp + c);
                const uint32_t f[CH] = {fv.x, fv.y, fv.z, fv.w};
#pragma unroll
                for (int i = 0; i < CH; ++i) {
                    acc[k][0] += (unsigned long long)y[i].x * f[i];
                    acc[k][1] += (unsigned long long)y[i].y * f[i];
                }
            }
            if (c + CH < wp) {
#pragma unroll
                for (int k = 0; k < TG; ++k) {
                    const Row r = r_s[g + k];
                    acc[k][0] = fold(acc[k][0], r);
                    acc[k][1] = fold(acc[k][1], r);
                }
            }
        }
#pragma unroll
        for (int k = 0; k < TG; ++k) {
            if (t0 + g + k < T) {
                const Row r = r_s[g + k];
                *reinterpret_cast<longlong2*>(o + (long long)(t0 + g + k) * n) =
                    make_longlong2(finish(acc[k][0], r), finish(acc[k][1], r));
            }
        }
    }
}

// The dynamic shared memory of a block whose widest digit has w rows.
size_t smem_bytes(int w) {
    const size_t wp = (size_t)(w + CH - 1) / CH * CH;
    return wp * COLS * sizeof(uint32_t) + TT * wp * sizeof(uint32_t) + TT * sizeof(Row)
           + 3 * (size_t)w * sizeof(uint32_t);
}

}  // namespace

// out [B D, T, n] (contiguous): for batch b and digit d, rows lo[d] .. lo[d+1]-1
// of x, out[b D + d, t] = sum_i F[t, i] (x[b, i] H[i] mod Pin[i]) mod Pout[t].
// x [B, R, n] with batch and row strides sxb, sxr (even) and unit column steps,
// 16-byte aligned; H and Pin [R, 1] (row strides sh, spi), F [T, R] (row
// stride sf, unit column steps), Pout [T, 1] (row stride spo).  lo holds the
// D + 1 digit bounds, increasing from 0 to at most R.
extern "C" int rns_bconv(const int64_t* x, const int64_t* H, const int64_t* Pin,
                         const int64_t* F, const int64_t* Pout, int64_t* out, const int* lo,
                         int D, int B, int T, int R, int n, long long sxb, long long sxr,
                         long long sh, long long spi, long long sf, long long spo,
                         void* stream) {
    if (D < 1 || D > MAX_DIGITS || B < 1 || (long long)B * D > 65535 || T < 1 || n < 2
        || n % 2 || (n / 2 + THREADS - 1) / THREADS > 65535 || sxb % 2 || sxr % 2
        || lo[0] < 0 || lo[D] > R)
        return (int)cudaErrorInvalidValue;
    Digits dg;
    dg.count = D;
    int wmax = 0;
    for (int d = 0; d <= D; ++d) {
        dg.lo[d] = lo[d];
        if (d && lo[d] - lo[d - 1] < 1) return (int)cudaErrorInvalidValue;
        if (d && lo[d] - lo[d - 1] > wmax) wmax = lo[d] - lo[d - 1];
    }
    const size_t smem = smem_bytes(wmax);
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    // above 48 KB only once opted in: done at the first call, so that no
    // later call (a graph's capture) sets an attribute
    static const cudaError_t opted = cudaFuncSetAttribute(
        rns_bconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (opted != cudaSuccess) return (int)opted;
    const dim3 grid((unsigned)((T + TT - 1) / TT), (unsigned)((n / 2 + THREADS - 1) / THREADS),
                    (unsigned)(B * D));
    rns_bconv_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        x, H, Pin, F, Pout, out, dg, T, n, sxb, sxr, sh, spi, sf, spo);
    return (int)cudaGetLastError();
}
