// Merged-twiddle negacyclic butterfly NTT for Hopper (sm_90a): one launch a
// transform, a whole limb plane held in the shared memory of one thread-block
// cluster.
//
// Replaces the Pallas TPU kernel `fhe_sorting_tpu/core/pallas_ntt.py:kernel`
// (in `_pallas_ntt_call`), which holds a whole limb plane in VMEM for all
// log2(n) stages:
//     forward  Cooley-Tukey, natural -> bit-reversed order; stage s multiplies
//              the upper half of each of 2^s groups by psi_rev[2^s + g]
//     inverse  Gentleman-Sande with ipsi_rev, stages logn-1 .. 0, then * 1/n
//
// What bounds it on this card: bytes.  The function needs each residue read
// once and written once (8 B each way as int64) and one twiddle per butterfly
// group; a butterfly is about a dozen integer operations.  So the design
// moves every residue across device memory exactly once each way:
//   * A ring-2^17 plane is 512 KB as u32, more than one block's 227 KB, so a
//     cluster of C = 2^c blocks holds it, block b the contiguous residues
//     [b m, (b + 1) m), m = n / C.  Rings up to 2^14 take one block (c = 0).
//   * The first c forward stages pair residues m, 2m, .. apart, one in each
//     block.  They run in registers on the way in: a thread reads, for two
//     adjacent offsets j, the C residues e m + j straight from device memory
//     (16-byte loads, neighbouring threads on neighbouring addresses), does
//     the radix-C butterfly, and stores result e into block e's shared memory
//     (`cluster.map_shared_rank`).  One `cluster.sync()` later every block
//     owns its chunk and the remaining stages are local.  The inverse runs
//     the local stages first and the radix-C butterfly on the way out, reading
//     the C blocks' shared memory and writing device memory.
//   * The local stages run as register rounds: a thread takes 2^R residues
//     that differ in R index bits, does R stages on them, and puts them back,
//     so the 14 local stages of ring 2^17 are four trips through shared memory
//     (3 + 3 + 3 + 5 stages) and four barriers.  The last round takes the
//     five lowest bits, 32 adjacent residues a thread, with 16-byte accesses;
//     the chunk is padded by 4 words every 32, which spreads those accesses
//     over all banks, and every other round reads 32 adjacent words a warp:
//     no stage has a bank conflict.
//   * Boundary loads and stores are 16 bytes (two int64 residues).
//   * Twiddles come from a kernel-side table [Ltot, n] that packs
//     (w, floor(w 2^32 / p)) into 8 bytes, the size of the int64 twiddle it
//     replaces, so a product is Shoup's: one `umulhi`, two multiplies and a
//     conditional subtraction.
//
// Arithmetic: primes are below 2^31 and residues canonical.  For any u32 a,
// a w - hi32(a w') p lies in [0, 2p) (w' = floor(w 2^32 / p) loses less than
// one, the floor of the quotient less than one more), 2p < 2^32, so the low 32
// bits are the value and one conditional subtraction makes it canonical:
// equal to the plain version bit for bit.
//
// Layout: data [planes, n] int64 contiguous with planes = batch * L, one prime
// per limb.  The packed tables and the per-limb P, NINV [Ltot] are addressed
// through `limbs` (global limb index of each of the L data limbs).

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_LOG_CHUNK = 14;   // residues a block can hold: 2^14 u32 = 64 KB (+ padding)
constexpr int MAX_LOG_CLUSTER = 3;  // 8 blocks: the portable cluster size
constexpr int LAST = 5;             // stages of the last round: 32 adjacent residues a thread
constexpr int MAX_DEVICES = 64;
constexpr int MAX_THREADS = 256;    // three blocks of 72 KB an SM at ring 2^17, 80 registers a thread

__host__ __device__ __forceinline__ unsigned phys(unsigned i) {
    return i + ((i >> 5) << 2);     // 4 words of padding after every 32
}

// a w - hi32(a w') p: congruent to a w, in [0, 2p) for any u32 a
__device__ __forceinline__ uint32_t mul_lazy(uint32_t a, uint2 w, uint32_t p) {
    return a * w.x - __umulhi(a, w.y) * p;
}

// x in [0, 2m) -> [0, m): where x < m, x - m wraps above x
__device__ __forceinline__ uint32_t correct(uint32_t x, uint32_t m) {
    return min(x, x - m);
}

__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint2 w, uint32_t p) {
    return correct(mul_lazy(a, w, p), p);
}

// One butterfly on (a, b) with twiddle w.  Strict (primes below 2^31): residues
// stay canonical.  LAZY (every prime below 2^30, so 4p fits 32 bits; Harvey's
// form): forward values stay in [0, 4p), inverse values in [0, 2p), and the
// kernel corrects them once on the way out.
template <bool INV, bool LAZY>
__device__ __forceinline__ void butterfly(uint32_t& a, uint32_t& b, uint2 w, uint32_t p) {
    if (LAZY) {
        const uint32_t p2 = 2u * p;
        if (!INV) {
            const uint32_t x = correct(a, p2);          // [0, 2p)
            const uint32_t t = mul_lazy(b, w, p);       // [0, 2p)
            a = x + t;                                  // [0, 4p)
            b = x - t + p2;                             // (0, 4p)
        } else {
            const uint32_t t = a - b + p2;              // (0, 4p)
            a = correct(a + b, p2);                     // [0, 2p)
            b = mul_lazy(t, w, p);                      // [0, 2p)
        }
    } else if (!INV) {
        const uint32_t t = mulmod(b, w, p);
        const uint32_t x = a;
        a = correct(x + t, p);                          // x + t < 2p < 2^32
        b = min(x - t, x - t + p);                      // x - t wraps where x < t
    } else {
        const uint32_t x = a, y = b;
        a = correct(x + y, p);
        b = mulmod(min(x - y, x - y + p), w, p);
    }
}

// R butterfly stages in registers on 2^R slots of W residues each.  Slot e
// stands for index bit pattern e in the R bits the stages combine; stage j
// (global stage s0 + j) pairs slots that differ in bit R-1-j, and its twiddle
// index is 2^(s0+j) + (pre << j) + (e >> (R-j)), where `pre` is the value of
// the index bits above those R bits.  Forward runs j upwards (Cooley-Tukey),
// the inverse downwards (Gentleman-Sande).
template <int R, int W, bool INV, bool LAZY>
__device__ __forceinline__ void reg_stages(uint32_t (&v)[1 << R][W], const uint2* __restrict__ tw,
                                           int s0, unsigned pre, uint32_t p) {
#pragma unroll
    for (int jj = 0; jj < R; ++jj) {
        const int j = INV ? R - 1 - jj : jj;
        const int half = 1 << (R - 1 - j);
        const unsigned idx0 = (1u << (s0 + j)) + (pre << j);
#pragma unroll
        for (int e = 0; e < (1 << R); ++e) {
            if (e & half) continue;
            const uint2 w = tw[idx0 + (e >> (R - j))];
#pragma unroll
            for (int l = 0; l < W; ++l) butterfly<INV, LAZY>(v[e][l], v[e + half][l], w, p);
        }
    }
}

// One round on the block's chunk: local stages [t0, t0 + R) on every group of
// 2^R residues whose local indices differ in bits [lm-t0-R, lm-t0).
template <int R, bool INV, bool LAZY>
__device__ __forceinline__ void round_strided(uint32_t* sm, const uint2* __restrict__ tw,
                                              int lm, int c_log, unsigned rank, int t0,
                                              uint32_t p) {
    const int lowbits = lm - t0 - R;
    const unsigned lowmask = (1u << lowbits) - 1u;
    for (unsigned gi = threadIdx.x; gi < (1u << (lm - R)); gi += blockDim.x) {
        const unsigned lo = gi & lowmask, hi = gi >> lowbits;
        const unsigned base = (hi << (lm - t0)) | lo;
        uint32_t v[1 << R][1];
#pragma unroll
        for (int e = 0; e < (1 << R); ++e) v[e][0] = sm[phys(base + ((unsigned)e << lowbits))];
        reg_stages<R, 1, INV, LAZY>(v, tw, c_log + t0, (rank << t0) + hi, p);
#pragma unroll
        for (int e = 0; e < (1 << R); ++e) sm[phys(base + ((unsigned)e << lowbits))] = v[e][0];
    }
    __syncthreads();
}

// The last round: local stages [lm - R, lm) on groups of 2^R adjacent residues.
template <int R, bool INV, bool LAZY>
__device__ __forceinline__ void round_adjacent(uint32_t* sm, const uint2* __restrict__ tw,
                                               int lm, int c_log, unsigned rank,
                                               uint32_t p) {
    const int t0 = lm - R;
    for (unsigned gi = threadIdx.x; gi < (1u << t0); gi += blockDim.x) {
        uint32_t* at = sm + phys(gi << R);
        uint32_t v[1 << R][1];
        if constexpr (R >= 2) {
#pragma unroll
            for (int e = 0; e < (1 << R); e += 4) {
                const uint4 q = *reinterpret_cast<const uint4*>(at + e);
                v[e][0] = q.x; v[e + 1][0] = q.y; v[e + 2][0] = q.z; v[e + 3][0] = q.w;
            }
        } else {
#pragma unroll
            for (int e = 0; e < (1 << R); ++e) v[e][0] = at[e];
        }
        reg_stages<R, 1, INV, LAZY>(v, tw, c_log + t0, (rank << t0) + gi, p);
        if constexpr (R >= 2) {
#pragma unroll
            for (int e = 0; e < (1 << R); e += 4)
                *reinterpret_cast<uint4*>(at + e) =
                    make_uint4(v[e][0], v[e + 1][0], v[e + 2][0], v[e + 3][0]);
        } else {
#pragma unroll
            for (int e = 0; e < (1 << R); ++e) at[e] = v[e][0];
        }
    }
    __syncthreads();
}

template <bool INV, bool LAZY>
__device__ __forceinline__ void run_strided(int r, uint32_t* sm, const uint2* tw, int lm, int c_log,
                                            unsigned rank, int t0, uint32_t p) {
    if (r == 3) round_strided<3, INV, LAZY>(sm, tw, lm, c_log, rank, t0, p);
    else if (r == 2) round_strided<2, INV, LAZY>(sm, tw, lm, c_log, rank, t0, p);
    else round_strided<1, INV, LAZY>(sm, tw, lm, c_log, rank, t0, p);
}

template <bool INV, bool LAZY>
__device__ __forceinline__ void run_adjacent(int r, uint32_t* sm, const uint2* tw, int lm, int c_log,
                                             unsigned rank, uint32_t p) {
    if (r == 5) round_adjacent<5, INV, LAZY>(sm, tw, lm, c_log, rank, p);
    else if (r == 4) round_adjacent<4, INV, LAZY>(sm, tw, lm, c_log, rank, p);
    else if (r == 3) round_adjacent<3, INV, LAZY>(sm, tw, lm, c_log, rank, p);
    else if (r == 2) round_adjacent<2, INV, LAZY>(sm, tw, lm, c_log, rank, p);
    else round_adjacent<1, INV, LAZY>(sm, tw, lm, c_log, rank, p);
}

// The stages of the strided rounds before the last one: threes, a rest of
// four as two twos.
__host__ __device__ __forceinline__ int pick_round(int left) {
    return left == 4 ? 2 : (left < 3 ? left : 3);
}

// One transform of every plane; a cluster of 2^C_LOG blocks per plane.
template <int C_LOG, bool LAZY>
__global__ void __launch_bounds__(MAX_THREADS, 3) bf_cluster_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                                  const uint2* __restrict__ tw,
                                  const int64_t* __restrict__ P,
                                  const int64_t* __restrict__ NINV,
                                  const int64_t* __restrict__ limbs,
                                  int logn, int L, int inverse) {
    constexpr int C = 1 << C_LOG;
    extern __shared__ __align__(16) uint32_t sm[];

    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = C > 1 ? cluster.block_rank() : 0u;
    const unsigned z = blockIdx.x >> C_LOG;                 // plane
    const int lm = logn - C_LOG;                            // log2 of the block's chunk
    const unsigned m = 1u << lm;

    const int64_t g = limbs[z % L];
    const uint32_t p = (uint32_t)P[g];
    const uint2* twp = tw + (g << logn);
    const int64_t* src = in + ((size_t)z << logn);
    int64_t* dst = out + ((size_t)z << logn);

    const int last = lm < LAST ? lm : LAST;
    const int early = lm - last;                            // stages of the strided rounds
    const unsigned items = (m >> C_LOG) >> 1;               // pairs of offsets of the radix-C phase
    const unsigned j0 = rank * (m >> C_LOG);

    uint32_t* peer[C];
#pragma unroll
    for (int e = 0; e < C; ++e) peer[e] = C > 1 ? cluster.map_shared_rank(sm, e) : sm;

    if (!inverse) {
        // every block of the cluster must be running before its shared memory is written
        if (C > 1) cluster.sync();
        for (unsigned it = threadIdx.x; it < items; it += blockDim.x) {
            const unsigned j = j0 + 2 * it;
            uint32_t v[C][2];
#pragma unroll
            for (int e = 0; e < C; ++e) {
                const longlong2 q = *reinterpret_cast<const longlong2*>(src + ((size_t)e << lm) + j);
                v[e][0] = (uint32_t)q.x; v[e][1] = (uint32_t)q.y;
            }
            reg_stages<C_LOG, 2, false, LAZY>(v, twp, 0, 0u, p);
#pragma unroll
            for (int e = 0; e < C; ++e)
                *reinterpret_cast<uint2*>(peer[e] + phys(j)) = make_uint2(v[e][0], v[e][1]);
        }
        if (C > 1) cluster.sync(); else __syncthreads();

        for (int t = 0; t < early;) {
            const int r = pick_round(early - t);
            run_strided<false, LAZY>(r, sm, twp, lm, C_LOG, rank, t, p);
            t += r;
        }
        run_adjacent<false, LAZY>(last, sm, twp, lm, C_LOG, rank, p);

        int64_t* chunk = dst + ((size_t)rank << lm);
        for (unsigned i = 2 * threadIdx.x; i < m; i += 2 * blockDim.x) {
            uint2 q = *reinterpret_cast<const uint2*>(sm + phys(i));
            if (LAZY) {                                 // [0, 4p) -> [0, p)
                q.x = correct(correct(q.x, 2u * p), p);
                q.y = correct(correct(q.y, 2u * p), p);
            }
            *reinterpret_cast<longlong2*>(chunk + i) = make_longlong2((long long)q.x, (long long)q.y);
        }
    } else {
        const int64_t* chunk = src + ((size_t)rank << lm);
        for (unsigned i = 2 * threadIdx.x; i < m; i += 2 * blockDim.x) {
            const longlong2 q = *reinterpret_cast<const longlong2*>(chunk + i);
            *reinterpret_cast<uint2*>(sm + phys(i)) = make_uint2((uint32_t)q.x, (uint32_t)q.y);
        }
        __syncthreads();

        run_adjacent<true, LAZY>(last, sm, twp, lm, C_LOG, rank, p);
        int starts[MAX_LOG_CHUNK], rounds = 0;
        for (int t = 0; t < early; t += pick_round(early - t)) starts[rounds++] = t;
        for (int k = rounds - 1; k >= 0; --k)
            run_strided<true, LAZY>(pick_round(early - starts[k]), sm, twp, lm, C_LOG, rank, starts[k], p);

        if (C > 1) cluster.sync();
        const uint32_t ninv = (uint32_t)NINV[g];
        const uint2 nw = make_uint2(ninv, (uint32_t)(((uint64_t)ninv << 32) / p));
        for (unsigned it = threadIdx.x; it < items; it += blockDim.x) {
            const unsigned j = j0 + 2 * it;
            uint32_t v[C][2];
#pragma unroll
            for (int e = 0; e < C; ++e) {
                const uint2 q = *reinterpret_cast<const uint2*>(peer[e] + phys(j));
                v[e][0] = q.x; v[e][1] = q.y;
            }
            reg_stages<C_LOG, 2, true, LAZY>(v, twp, 0, 0u, p);
#pragma unroll
            for (int e = 0; e < C; ++e)
                *reinterpret_cast<longlong2*>(dst + ((size_t)e << lm) + j) = make_longlong2(
                    (long long)mulmod(v[e][0], nw, p), (long long)mulmod(v[e][1], nw, p));
        }
        // no block may leave while another still reads its shared memory
        if (C > 1) cluster.sync();
    }
}

struct Shape {
    unsigned threads;
    size_t smem;
};

Shape shape_of(int logn, int c_log) {
    const int lm = logn - c_log;
    const unsigned m = 1u << lm;
    unsigned threads = m >> LAST;
    if (threads > (unsigned)MAX_THREADS) threads = MAX_THREADS;
    if (threads < 32u) threads = 32u;
    return {threads, (size_t)phys(m) * sizeof(uint32_t)};
}

bool valid(int logn, int c_log) {
    return c_log >= 0 && c_log <= MAX_LOG_CLUSTER && logn - c_log >= 1 + c_log &&
           logn - c_log <= MAX_LOG_CHUNK && logn <= 30;
}

template <int C_LOG, bool LAZY>
int prepare(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int logn, int planes,
            cudaStream_t stream) {
    const Shape sh = shape_of(logn, C_LOG);
    // the most dynamic shared memory asked for so far, per device ordinal
    static size_t allowed[MAX_DEVICES] = {};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
        return (int)cudaErrorInvalidDevice;
    if (sh.smem > 48 * 1024 && sh.smem > allowed[dev]) {
        cudaError_t e = cudaFuncSetAttribute(bf_cluster_kernel<C_LOG, LAZY>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
        if (e != cudaSuccess) return (int)e;
        allowed[dev] = sh.smem;
    }
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3((unsigned)planes << C_LOG);
    cfg->blockDim = dim3(sh.threads);
    cfg->dynamicSmemBytes = sh.smem;
    cfg->stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = 1u << C_LOG;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return 0;
}

struct Args {
    const int64_t* in;
    int64_t* out;
    const uint2* tw;
    const int64_t *P, *NINV, *limbs;
    int logn, L, planes, inverse;
    cudaStream_t stream;
    int* clusters;      // non-null: only ask how many clusters the card holds at once
};

template <int C_LOG, bool LAZY>
int run(const Args& a) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    const int rc = prepare<C_LOG, LAZY>(&cfg, &attr, a.logn, a.planes, a.stream);
    if (rc) return rc;
    if (a.clusters) {
        // the query reads the cluster's shape and the block's resources, not the grid's extent
        cfg.gridDim = dim3(1024u << C_LOG);
        return (int)cudaOccupancyMaxActiveClusters(a.clusters, bf_cluster_kernel<C_LOG, LAZY>, &cfg);
    }
    cudaError_t e = cudaLaunchKernelEx(&cfg, bf_cluster_kernel<C_LOG, LAZY>, a.in, a.out, a.tw,
                                       a.P, a.NINV, a.limbs, a.logn, a.L, a.inverse);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <bool LAZY>
int dispatch(int c_log, const Args& a) {
    switch (c_log) {
        case 0: return run<0, LAZY>(a);
        case 1: return run<1, LAZY>(a);
        case 2: return run<2, LAZY>(a);
        default: return run<3, LAZY>(a);
    }
}

}  // namespace

// One transform (forward, or inverse with the 1/n scaling) of every plane, one
// cluster of 2^c_log blocks per plane, in one launch.  `lazy` may be set where
// every prime is below 2^30; the outputs are the same canonical residues.
extern "C" int bf_ntt_transform(const int64_t* in, int64_t* out, const void* tw,
                                const int64_t* P, const int64_t* NINV, const int64_t* limbs,
                                int logn, int c_log, int L, int planes, int inverse, int lazy,
                                void* stream) {
    if (!valid(logn, c_log) || L < 1 || planes < 1 || planes % L ||
        ((long long)planes << c_log) > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const Args a{in, out, (const uint2*)tw, P, NINV, limbs, logn, L, planes, inverse,
                 (cudaStream_t)stream, nullptr};
    return lazy ? dispatch<true>(c_log, a) : dispatch<false>(c_log, a);
}

// How many clusters of 2^c_log blocks (that is, planes of ring 2^logn) the
// card can hold at once: `cudaOccupancyMaxActiveClusters`.
extern "C" int bf_ntt_max_active_clusters(int logn, int c_log, int lazy, int* clusters) {
    if (!valid(logn, c_log)) return (int)cudaErrorInvalidValue;
    const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, logn, 1, 1, 0, nullptr,
                 clusters};
    return lazy ? dispatch<true>(c_log, a) : dispatch<false>(c_log, a);
}
