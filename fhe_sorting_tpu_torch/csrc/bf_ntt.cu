// Merged-twiddle negacyclic butterfly NTT for Hopper (sm_90a): one kernel that
// runs a range of butterfly stages of one tile in shared memory.
//
// Replaces the Pallas TPU kernel `fhe_sorting_tpu/core/pallas_ntt.py:kernel`
// (in `_pallas_ntt_call`), which holds a whole limb plane in VMEM for all
// log2(n) stages:
//     forward  Cooley-Tukey, natural -> bit-reversed order; stage s multiplies
//              the upper half of each of 2^s groups by psi_rev[2^s + g]
//     inverse  Gentleman-Sande with ipsi_rev, stages logn-1 .. 0, then * 1/n
// A ring-2^17 limb plane is 512 KB as u32, more than the 227 KB of shared
// memory a block can use, so a transform is a few launches ("passes") of the
// kernel below; the wrapper (`core/bf_ntt.py`) derives them from n.  A pass
// runs stages [s0, s1).  With i = (o << (logn - s0)) | (a << (logn - s1)) | c,
// those stages only combine elements that differ in the bits `a`, so a block
// takes one `o`, all 2^(s1-s0) values of `a` and 2^logT adjacent values of
// `c`: rows of 2^logT adjacent residues, 2^(logn-s1) apart.  The last
// forward pass has s1 = logn and logT = 0: a contiguous chunk.  The first
// pass reads the input and writes the output; later passes run in place on
// the output, each block on its own tile.  One launch does it all for
// n <= 2^13.
//
// What bounds it on this card: bytes.  A pass reads and writes every residue
// once (8 B each way as int64) and does (s1 - s0) / 2 butterflies per residue,
// each about a dozen integer operations, far below the card's
// operation-to-byte ratio.  The design therefore keeps the number of
// passes small (two at ring 2^17), reads and writes rows of adjacent
// residues (1 KB at ring 2^17 in the strided pass) and holds the tile as u32.
// Twiddles of the strided passes are shared by whole rows (broadcast loads);
// those of the last stages are read once each, contiguously.
//
// Arithmetic: primes are below 2^31, residues are canonical.  A product
// a * w < 2^62 is reduced by Barrett with mu = floor(2^64 / p): the estimate
// q = hi64(x * mu) is the true quotient or one less, so x - q p lies in
// [0, 2p) and one conditional subtraction finishes it.  Outputs are canonical
// residues, so they equal the plain version's bit for bit.
//
// Layout: data [planes, n] int64 contiguous with planes = batch * L, one prime
// per limb.  Tables [Ltot, n] int64 and the per-limb P, NINV [Ltot] are
// addressed through `limbs` (global limb index of each of the L data limbs).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LOG_TILE = 13;   // 8192 u32 = 32 KB of shared memory

__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b, uint32_t p, uint64_t mu) {
    const uint64_t x = (uint64_t)a * b;
    const uint64_t q = __umul64hi(x, mu);
    uint32_t r = (uint32_t)x - (uint32_t)q * p;     // true value < 2p < 2^32
    return r >= p ? r - p : r;
}

__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b, uint32_t p) {
    const uint32_t t = a + b;                        // < 2^32
    return t >= p ? t - p : t;
}

__device__ __forceinline__ uint32_t submod(uint32_t a, uint32_t b, uint32_t p) {
    return a >= b ? a - b : a + p - b;
}

// `in` and `out` may be the same buffer (an in-place pass), so neither is
// declared __restrict__.
__global__ void bf_pass_kernel(const int64_t* in, int64_t* out,
                               const int64_t* __restrict__ tw,
                               const int64_t* __restrict__ P,
                               const int64_t* __restrict__ NINV,
                               const int64_t* __restrict__ limbs,
                               int logn, int s0, int s1, int logT, int L,
                               int inverse, int scale) {
    extern __shared__ uint32_t sm[];

    const int logA = s1 - s0;               // stages of this pass
    const int logcols = logn - s1;          // log2 of the distance between rows
    const int logtile = logA + logT;
    const int logtpo = logcols - logT;      // log2 of tiles per value of o
    const int logtiles = logn - logtile;    // log2 of tiles per plane

    const unsigned bid = blockIdx.x;
    const unsigned z = bid >> logtiles;                       // plane
    const unsigned q = bid & ((1u << logtiles) - 1u);         // tile in the plane
    const unsigned o = q >> logtpo;
    const unsigned c0 = (q & ((1u << logtpo) - 1u)) << logT;

    const int64_t g = limbs[z % L];
    const uint32_t p = (uint32_t)P[g];
    const uint64_t mu = ~0ull / p;          // floor(2^64 / p): p is odd
    const int64_t* twp = tw + (g << logn);

    const size_t base = ((size_t)z << logn) + ((size_t)o << (logA + logcols)) + c0;
    const unsigned tile = 1u << logtile;
    const unsigned tmask = (1u << logT) - 1u;

    for (unsigned e = threadIdx.x; e < tile; e += blockDim.x)
        sm[e] = (uint32_t)in[base + ((size_t)(e >> logT) << logcols) + (e & tmask)];
    __syncthreads();

    for (int st = 0; st < logA; ++st) {
        const int s = inverse ? s1 - 1 - st : s0 + st;
        const int lgh = (s1 - s - 1) + logT;        // log2 of the pair distance in sm
        const unsigned hmask = (1u << lgh) - 1u;
        const unsigned tw0 = (1u << s) + (o << (s - s0));
        for (unsigned k = threadIdx.x; k < (tile >> 1); k += blockDim.x) {
            const unsigned grp = k >> lgh;
            const unsigned lo = (grp << (lgh + 1)) | (k & hmask);
            const unsigned hi = lo + (1u << lgh);
            const uint32_t w = (uint32_t)twp[tw0 + grp];
            const uint32_t u = sm[lo];
            const uint32_t v = sm[hi];
            if (!inverse) {
                const uint32_t vw = mulmod(v, w, p, mu);
                sm[lo] = addmod(u, vw, p);
                sm[hi] = submod(u, vw, p);
            } else {
                sm[lo] = addmod(u, v, p);
                sm[hi] = mulmod(submod(u, v, p), w, p, mu);
            }
        }
        __syncthreads();
    }

    const uint32_t ninv = scale ? (uint32_t)NINV[g] : 0u;
    for (unsigned e = threadIdx.x; e < tile; e += blockDim.x) {
        uint32_t v = sm[e];
        if (scale) v = mulmod(v, ninv, p, mu);
        out[base + ((size_t)(e >> logT) << logcols) + (e & tmask)] = (int64_t)v;
    }
}

}  // namespace

// One pass: stages [s0, s1) of every plane, forward (ascending) or inverse
// (descending, Gentleman-Sande); `scale` multiplies by NINV on the way out.
extern "C" int bf_ntt_pass(const int64_t* in, int64_t* out, const int64_t* tw,
                           const int64_t* P, const int64_t* NINV, const int64_t* limbs,
                           int logn, int s0, int s1, int logT, int L, int planes,
                           int inverse, int scale, void* stream) {
    const int logtile = (s1 - s0) + logT;
    if (s0 < 0 || s1 <= s0 || s1 > logn || logT < 0 || logT > logn - s1 ||
        logtile < 1 || logtile > MAX_LOG_TILE || L < 1 || planes < 1 || planes % L)
        return (int)cudaErrorInvalidValue;
    const long long blocks = (long long)planes << (logn - logtile);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const unsigned tile = 1u << logtile;
    unsigned threads = tile >> 1;
    if (threads > 512u) threads = 512u;
    if (threads < 32u) threads = 32u;
    bf_pass_kernel<<<(unsigned)blocks, threads, tile * sizeof(uint32_t), (cudaStream_t)stream>>>(
        in, out, tw, P, NINV, limbs, logn, s0, s1, logT, L, inverse, scale);
    return (int)cudaGetLastError();
}
