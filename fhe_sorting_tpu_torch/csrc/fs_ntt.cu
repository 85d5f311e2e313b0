// Four-step negacyclic NTT for Hopper (sm_90a): one per-limb modular matmul
// kernel with an optional Shoup-twiddle epilogue.
//
// Replaces the Pallas TPU kernel `fhe_sorting_tpu/core/pallas_fs_ntt.py:_kernel`,
// which runs a whole [n1, n2] limb plane per grid step in VMEM:
//     forward  Y = ((W1 @ X) * T) @ W2
//     inverse  Y = W1i @ ((X @ W2i) * Ti)
// A ring-2^17 limb plane is 1 MB of int64, more than the 227 KB of shared
// memory a block can use, so each transform is two launches of the kernel
// below (forward: V = (W1 @ X) * T, then Y = V @ W2; inverse: S = (X @ W2i) * Ti,
// then Y = W1i @ S).  The wrapper (`core/fs_ntt.py`) allocates V/S.
//
// What bounds it on this card: integer multiply issue.  The four-step does
// n * (n1 + n2) multiply-adds per limb plane (100 M at ring 2^17), and this
// version runs them as 32x32 -> 64-bit IMAD.WIDE on the CUDA cores, not on
// the tensor cores; each table tile is read from L2, so memory is not the
// limit.  The design keeps the multiply-add as the only per-product work:
// residues are below 2^30, so eight products (< 2^63) are summed in a
// uint64 accumulator before one fold by 2^32 mod p, and the full reduction
// mod p happens once per output.  The s8 digit-plane product on the
// tensor cores (wgmma) is the later, faster form.
//
// Layout: data [batch, L, rows, cols] int64 contiguous, one prime per limb.
// Tables [Ltot, ...] int64 are addressed through `limbs` (global limb index
// of each of the L data limbs), so subsets of the chain need no table copy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;   // output rows per block
constexpr int TN = 64;   // output cols per block
constexpr int TK = 16;   // depth per shared-memory stage
constexpr int THREADS = 256;

__device__ __forceinline__ uint64_t fold32(uint64_t acc, uint64_t r32) {
    // acc < 2^64  ->  (acc >> 32) * r32 + (acc & 0xffffffff) < 2^62 + 2^32
    return (acc >> 32) * r32 + (acc & 0xffffffffull);
}

// C[z] = A[z] @ B[z] mod p  (optionally * T mod p, Shoup), z = b * L + l.
// Exactly one of A, B is a table (indexed by limbs[l]), the other is data.
__global__ void __launch_bounds__(THREADS)
modmm_kernel(const int64_t* __restrict__ A, int a_tab,
             const int64_t* __restrict__ B, int b_tab,
             int64_t* __restrict__ C,
             const int64_t* __restrict__ T, const int64_t* __restrict__ Tsh,
             const int64_t* __restrict__ P, const int64_t* __restrict__ limbs,
             int M, int N, int K, int L) {
    __shared__ uint32_t As[TK][TM + 1];   // +1: transposed stores avoid bank conflicts
    __shared__ uint32_t Bs[TK][TN];

    const int z = blockIdx.z;
    const int64_t g = limbs[z % L];
    const int64_t* Ap = A + (a_tab ? g : (int64_t)z) * M * K;
    const int64_t* Bp = B + (b_tab ? g : (int64_t)z) * K * N;
    const uint32_t p = (uint32_t)P[g];
    const uint64_t r32 = (1ull << 32) % p;

    const int m0 = blockIdx.y * TM;
    const int n0 = blockIdx.x * TN;
    const int tid = threadIdx.x;
    const int tx = tid % 16;   // output cols tx + 16 j
    const int ty = tid / 16;   // output rows ty + 16 i

    uint64_t acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;

    for (int k0 = 0; k0 < K; k0 += TK) {
        // A tile [TM, TK], stored transposed; consecutive threads read
        // consecutive k of one row
#pragma unroll
        for (int r = 0; r < TM * TK / THREADS; ++r) {
            const int e = tid + r * THREADS;
            const int m = e / TK, k = e % TK;
            As[k][m] = (uint32_t)Ap[(int64_t)(m0 + m) * K + k0 + k];
        }
        // B tile [TK, TN]; consecutive threads read consecutive columns
#pragma unroll
        for (int r = 0; r < TK * TN / THREADS; ++r) {
            const int e = tid + r * THREADS;
            const int k = e / TN, n = e % TN;
            Bs[k][n] = (uint32_t)Bp[(int64_t)(k0 + k) * N + n0 + n];
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) {
            uint32_t av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] += (uint64_t)av[i] * bv[j];
            if ((kk & 7) == 7) {
                // 8 products < 2^63 were added to a value < 2^62 + 2^32
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fold32(acc[i][j], r32);
            }
        }
        __syncthreads();
    }

    int64_t* Cp = C + (int64_t)z * M * N;
    const int64_t* Tp = T ? T + g * M * N : nullptr;
    const int64_t* Tshp = T ? Tsh + g * M * N : nullptr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = m0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = n0 + tx + 16 * j;
            const int64_t off = (int64_t)row * N + col;
            uint32_t v = (uint32_t)(acc[i][j] % p);
            if (Tp) {
                // Shoup: v * t mod p with tsh = floor(t * 2^32 / p)
                const uint32_t t = (uint32_t)Tp[off];
                const uint32_t q = __umulhi(v, (uint32_t)Tshp[off]);
                uint32_t r = v * t - q * p;
                v = r >= p ? r - p : r;
            }
            Cp[off] = (int64_t)v;
        }
    }
}

}  // namespace

extern "C" int fs_modmm(const int64_t* A, int a_tab, const int64_t* B, int b_tab,
                        int64_t* C, const int64_t* T, const int64_t* Tsh,
                        const int64_t* P, const int64_t* limbs,
                        int M, int N, int K, int L, int batch, void* stream) {
    if (M % TM || N % TN || K % TK) return (int)cudaErrorInvalidValue;
    dim3 grid(N / TN, M / TM, batch * L);
    modmm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        A, a_tab, B, b_tab, C, T, Tsh, P, limbs, M, N, K, L);
    return (int)cudaGetLastError();
}
