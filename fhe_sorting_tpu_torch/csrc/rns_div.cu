// K3: the exact division of RNS planes by a modulus they drop, for Hopper
// (sm_90a): the elementwise work on either side of the NTT in every rescale,
// and the last step of ModDown.
//
// Replaces no TPU kernel: the JAX package leaves this arithmetic to XLA, which
// fuses it into the programs around it.  It was added because the op census
// (`utils/profile_sort.py`) ranks the rescale's elementwise chain first in
// device time: PyTorch ran it as a dozen int64 kernels (a 64-bit `remainder`
// over every residue, twice, then compares, subtractions and `where`s), each
// reading and writing whole [B, r, n] planes.
//
// Dividing by a dropped modulus q (q_last in a rescale, the special product P
// in ModDown) has two elementwise halves, with an NTT between them:
//   lift       t_i = x mod p_i, less q mod p_i where x >= ceil(q / 2)  (mod p_i)
//              x [B, 1, n]: the dropped limb's coefficients, in [0, q)
//   sub_scale  out_i = (a_i - b_i) w_i mod p_i
//              a [B, r, n] the kept rows (a strided view of the planes it
//              came from), b [B, r, n] the NTT of t, w_i = q^-1 mod p_i
// Every residue is canonical in [0, p) and every prime is below 2^31, so both
// run in 32-bit arithmetic: x mod p by Barrett's quotient m = floor(2^32 / p)
// (one `umulhi`, a multiply, a subtraction and a conditional one: x < 2^32
// gives the quotient or one less), w d mod p by Shoup's with
// w' = floor(w 2^32 / p).  A block works on one row (the lift on LIFT_ROWS),
// so it divides once for each of its rows' quotients, in one thread, while its
// loads are in flight, and shares them through shared memory: the residues
// see no division, and the context keeps no table beyond the rows' primes and
// constants it has (p, q mod p, w).  The outputs are the canonical residues of
// the plain version, bit for bit.
//
// What bounds it on this card: bytes.  A few integer operations a residue
// against 8 bytes moved each way at the port's int64 layout.  With S the kept
// residues (B r n):
//   lift       reads the B n coefficients and writes t: 8 S bytes (the
//              coefficients are read once per group of LIFT_ROWS rows, 1/8 of
//              a row each time);
//   sub_scale  reads a and b and writes out: 24 S bytes.
// At 3.35 TB/s that is 2.4 S ps and 7.2 S ps; the rescale at the top of a
// ring-2^17 chain of 68 limbs (B = 2, r = 67) is 0.042 ms and 0.126 ms.  The
// design moves each of those bytes once:
//   * one thread takes two adjacent residues of a row: every load and store is
//     16 bytes (two int64), neighbouring threads on neighbouring addresses;
//   * a block is 256 threads along one row (blockIdx.y picks the row, or the
//     group of LIFT_ROWS rows for the lift, blockIdx.z the batch), so a row's
//     constants are uniform loads, and its quotients one division a block;
//   * a lift thread reads its two coefficients once and writes them, reduced,
//     into each of its LIFT_ROWS rows;
//   * `a` and `x` take a batch stride, and the constants [r, 1] a row stride,
//     so views of the kept rows (and a limb rank's rows of the constants) are
//     read in place, not copied first.
// Folding the lift into the NTT's first pass and sub_scale into its last would
// save the 16 S bytes of t and b.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;    // a block: 256 threads along one row, two residues each
constexpr int LIFT_ROWS = 8;    // the rows one lift thread writes

// w x mod p by Shoup's quotient ws = floor(w 2^32 / p), for x < 2^32 and
// w < p < 2^31: the estimate of floor(w x / p) is exact or one less, so the
// remainder lies in [0, 2p) and 32 bits hold it.
__device__ __forceinline__ uint32_t shoup(uint32_t x, uint32_t w, uint32_t ws, uint32_t p) {
    const uint32_t r = x * w - __umulhi(x, ws) * p;
    return r >= p ? r - p : r;
}

// The lift of one coefficient x in [0, q): x mod p, less c = q mod p where
// x >= half = ceil(q / 2).  Barrett's reduction is Shoup's product by 1, with
// m = floor(2^32 / p), which for an odd p > 1 is floor((2^32 - 1) / p).
__device__ __forceinline__ long long lift1(uint32_t x, uint32_t half, uint32_t p, uint32_t m,
                                           uint32_t c) {
    const uint32_t t = shoup(x, 1u, m, p);
    if (x < half) return t;
    return t >= c ? t - c : t + p - c;
}

// (a - b) w mod p for a, b in [0, p).
__device__ __forceinline__ long long sub_scale1(long long a, long long b, uint32_t p, uint32_t w,
                                                uint32_t ws) {
    const uint32_t u = (uint32_t)a, v = (uint32_t)b;
    const uint32_t d = u >= v ? u - v : u + p - v;
    return shoup(d, w, ws, p);
}

// t [B, r, n] from x [B, 1, n] (batch stride sx); P and C [r, 1] (row
// strides sp, sc) hold each row's prime and q mod p.
__global__ void __launch_bounds__(THREADS) rns_lift_kernel(
        const int64_t* __restrict__ x, int64_t* __restrict__ t, const int64_t* __restrict__ P,
        const int64_t* __restrict__ C, uint32_t half, int r, int n, long long sx, long long sp,
        long long sc) {
    __shared__ uint32_t m_s[LIFT_ROWS];
    const int j = 2 * (blockIdx.x * THREADS + threadIdx.x);
    const int b = blockIdx.z, i0 = blockIdx.y * LIFT_ROWS;
    const int rows = min(LIFT_ROWS, r - i0);
    const bool live = j < n;
    longlong2 v = make_longlong2(0, 0);
    if (live) v = *reinterpret_cast<const longlong2*>(x + b * sx + j);
    if ((int)threadIdx.x < rows)
        m_s[threadIdx.x] = 0xffffffffu / (uint32_t)__ldg(P + (i0 + threadIdx.x) * sp);
    __syncthreads();
    if (!live) return;
    const uint32_t x0 = (uint32_t)v.x, x1 = (uint32_t)v.y;
    int64_t* out = t + ((long long)b * r + i0) * n + j;
#pragma unroll
    for (int i = 0; i < LIFT_ROWS; ++i) {
        if (i < rows) {
            const uint32_t p = (uint32_t)__ldg(P + (i0 + i) * sp);
            const uint32_t c = (uint32_t)__ldg(C + (i0 + i) * sc);
            *reinterpret_cast<longlong2*>(out + (long long)i * n) =
                make_longlong2(lift1(x0, half, p, m_s[i], c), lift1(x1, half, p, m_s[i], c));
        }
    }
}

// out [B, r, n] (contiguous) from a and b [B, r, n] (batch strides sa, sb;
// rows n apart); P and W [r, 1] (row strides sp, sw) hold each row's prime
// and multiplier.
__global__ void __launch_bounds__(THREADS) rns_sub_scale_kernel(
        const int64_t* __restrict__ a, const int64_t* __restrict__ b, int64_t* __restrict__ out,
        const int64_t* __restrict__ P, const int64_t* __restrict__ W, int r, int n, long long sa,
        long long sb, long long sp, long long sw) {
    __shared__ uint32_t ws_s;
    const int j = 2 * (blockIdx.x * THREADS + threadIdx.x);
    const int i = blockIdx.y, z = blockIdx.z;
    const bool live = j < n;
    const long long row = (long long)i * n + j;
    longlong2 u = make_longlong2(0, 0), v = u;
    if (live) {
        u = *reinterpret_cast<const longlong2*>(a + z * sa + row);
        v = *reinterpret_cast<const longlong2*>(b + z * sb + row);
    }
    const uint32_t p = (uint32_t)__ldg(P + i * sp), w = (uint32_t)__ldg(W + i * sw);
    if (threadIdx.x == 0) ws_s = (uint32_t)(((unsigned long long)w << 32) / p);
    __syncthreads();
    if (!live) return;
    const uint32_t ws = ws_s;
    *reinterpret_cast<longlong2*>(out + (long long)z * r * n + row) =
        make_longlong2(sub_scale1(u.x, v.x, p, w, ws), sub_scale1(u.y, v.y, p, w, ws));
}

bool valid(int B, int r, int n) {
    return B >= 1 && B <= 65535 && r >= 1 && r <= 65535 && n >= 2 && n % 2 == 0;
}

dim3 grid(int n, int rows, int B) {
    return dim3((unsigned)((n / 2 + THREADS - 1) / THREADS), (unsigned)rows, (unsigned)B);
}

}  // namespace

// The lift of x [B, 1, n] (batch stride sx) onto the r rows whose primes and
// q mod p are P and C [r, 1] (row strides sp, sc), into t [B, r, n].  x and t
// 16-byte aligned, sx even.
extern "C" int rns_lift(const int64_t* x, int64_t* t, const int64_t* P, const int64_t* C,
                        long long half, int B, int r, int n, long long sx, long long sp,
                        long long sc, void* stream) {
    if (!valid(B, r, n) || half < 0 || half > 0xffffffffLL || sx % 2)
        return (int)cudaErrorInvalidValue;
    rns_lift_kernel<<<grid(n, (r + LIFT_ROWS - 1) / LIFT_ROWS, B), THREADS, 0,
                      (cudaStream_t)stream>>>(x, t, P, C, (uint32_t)half, r, n, sx, sp, sc);
    return (int)cudaGetLastError();
}

// out [B, r, n] = (a - b) w mod p, row by row, with the primes and
// multipliers P and W [r, 1] (row strides sp, sw); a and b [B, r, n] with
// batch strides sa and sb and rows n apart.  a, b and out 16-byte aligned,
// sa and sb even.
extern "C" int rns_sub_scale(const int64_t* a, const int64_t* b, int64_t* out, const int64_t* P,
                             const int64_t* W, int B, int r, int n, long long sa, long long sb,
                             long long sp, long long sw, void* stream) {
    if (!valid(B, r, n) || sa % 2 || sb % 2) return (int)cudaErrorInvalidValue;
    rns_sub_scale_kernel<<<grid(n, r, B), THREADS, 0, (cudaStream_t)stream>>>(
        a, b, out, P, W, r, n, sa, sb, sp, sw);
    return (int)cudaGetLastError();
}
