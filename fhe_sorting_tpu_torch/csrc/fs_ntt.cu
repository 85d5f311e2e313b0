// Four-step negacyclic NTT for Hopper (sm_90a): one per-limb modular matmul
// kernel on the s8 tensor cores, with an optional Shoup-twiddle epilogue.
//
// Replaces the Pallas TPU kernel `fhe_sorting_tpu/core/pallas_fs_ntt.py:_kernel`,
// which runs a whole [n1, n2] limb plane per grid step in VMEM:
//     forward  Y = ((W1 @ X) * T) @ W2
//     inverse  Y = W1i @ ((X @ W2i) * Ti)
// A ring-2^17 limb plane is 1 MB of int64, more than the 227 KB of shared
// memory a block can use, so each transform is two launches of the kernel
// below (forward: V = (W1 @ X) * T, then Y = V @ W2; inverse: S = (X @ W2i) * Ti,
// then Y = W1i @ S).  The wrapper (`core/fs_ntt.py`) allocates V/S, which are
// the kernel's own and hold u32 residues (4 bytes an element).
//
// What bounds it on this card: operations.  The four-step does n * (n1 + n2)
// multiply-adds per limb plane (100 M at ring 2^17), 18 times what a butterfly
// NTT needs, so the products have to run on the tensor cores, as the TPU
// kernel's own algorithm intended.  A residue r < 2^30 is four balanced s8
// digits, r = sum_i d_i 256^i with d_i in [-128, 127]; a product of two
// residue matrices is 16 digit-pair s8 x s8 -> s32 products, summed into seven
// groups S_k = sum_{i+j=k} A_i B_j, k = 0..6, and sum_k S_k 256^k is reduced
// mod p once per output.
//
// Instruction: `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` (IMMA), with
// fragments from `ldmatrix`.  The kernel was also built on
// `wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8` (both operands through
// shared-memory descriptors, 8 x 16-byte core matrices without swizzle), was
// bit-exact, and was slower on an H100 than the `mma.sync` form of the same
// structure, every warp fetching and multiplying (1.04 ms against 0.92 ms for
// the forward NTT of [2, 68, 2^17], before this kernel's warps were
// specialised): seven accumulator groups allow a warpgroup only a 64 x 32 tile, so each of
// the 16 digit-pair `wgmma` of a k32 step fetches its 64-row operand from
// shared memory again for 64 x 32 x 32 multiply-adds.  `mma.sync` keeps the
// four digit planes of its rows in registers for all 16 products, and measures
// 66% of the card's s8 rate by itself, so it is what this kernel issues.
//
// Design.  One operand of each product is a constant table, the other is data.
//   * A block tile is 128 (table side) x 32 (data side) outputs, eight consumer
//     warps of 32 x 16 each: seven s32 accumulator groups are 112 registers a
//     thread, which caps the tile.  Ring 2^12 (64 x 64) runs the same kernel
//     with four consumer warps (64 x 32).
//   * Blocks are persistent, one an SM: block b takes output tiles b,
//     b + gridDim.x, .. and its ring of three stages (depth 64 each) runs on
//     across tile boundaries, so only a block's first tile waits for device
//     memory.
//   * Warps are specialised.  Four producer warps fetch, the consumer warps
//     only multiply and reduce; the two sides meet at named barriers (a
//     stage's data is stored; a stage is free) and never at a block-wide one,
//     so the tensor cores work on one stage while the next ones are fetched.
//     With all warps doing both, the two kinds of work took turns instead.
//   * Tables are s8 digit planes built once (`core/ntt_mxu.py`) and stored as
//     the stages the kernel reads: for each limb, table tile and step of the
//     depth, the four digit planes of 128 rows x 64 digits, every row padded to
//     the 80 bytes it takes in shared memory.  One thread brings a stage with
//     one bulk copy (`cp.async.bulk`, 40 KB) whose completion an mbarrier
//     reports to the consumers: no addresses, no registers, no waiting.
//   * Data (int64 residues in the first launch, u32 in the second) is loaded
//     into registers one step ahead, split into digits there, and stored to the
//     stage; two register sets take turns, so that no load is waited for
//     before its step.  All four digits of a residue come from two operations:
//     (v + 0x80808080) ^ 0x80808080 adds 128 at every byte position at once,
//     which carries exactly as the digit-by-digit rule does, and the xor takes
//     the 128 off each byte again; a 4 x 4 byte transpose (`prmt`) then packs
//     digit i of four consecutive k into one word.  Where the data is the right
//     operand [K, N], which lies N-contiguous in memory, the same split
//     transposes it: a thread reads four consecutive k of one column.
//   * Both operands lie in shared memory as rows of 64 digits (two k32 steps)
//     padded to 80 bytes, which keeps every `ldmatrix` and every digit store
//     free of bank conflicts.
//   * The per-prime constants of the reduction come from a table, not from
//     64-bit divisions in the kernel.
//
// Widths (K <= 512, 2^22 < p < 2^30).  |d_i d_j| <= 2^14 and S_k sums at most
// 4 K such products, so |S_k| <= 2^25: no s32 overflows.  With
// low = S_0 + 2^8 S_1 + 2^16 S_2 + 2^24 S_3 and high = S_4 + 2^8 S_5 + 2^16 S_6
// in int64, |low| < 2^50 and |high| < 2^42, and the product is
// high 2^32 + low.  Adding the multiples of p just above 2^50 and 2^42 makes
// both non-negative and below 2^52.  `red52` reduces such an x to [0, 3p) with
// one `umulhi`: q = hi32((x >> 20) * floor(2^52 / p)) is the quotient or up to
// two less (each floor loses less than one, 2^20 / p < 1/4).  Then
// (high mod p) * (2^32 mod p) by Shoup lies in [0, 2p), low is brought to
// [0, 2p), and the sum below 4p < 2^32 is corrected into [0, p): canonical, so
// equal to the plain version bit for bit.
//
// Layout: data and outputs [batch, L, M, N] contiguous, one prime per limb.
// Tables are addressed through `limbs` (global limb index of each of the L
// data limbs), so subsets of the chain need no table copy.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 64;        // depth of a stage: two m16n8k32 steps
constexpr int ROWB = BK + 16; // bytes of a shared-memory row: BK digits + 16 of padding
constexpr int DSIDE = 32;     // rows of the data operand in a block tile
constexpr int NSTAGE = 3;     // stages of the ring, 50 KB each
constexpr int MAX_K = 512;
constexpr uint32_t BIAS = 0x80808080u;

struct Mod {
    uint32_t p, p2, r32, r32sh, m52;
    int64_t offl, offh;
};

// The constants of limb g from `mods` [Ltot, 4] int64 (`core/ntt_mxu.py`):
// p | (2^32 mod p) << 32, its Shoup quotient | floor(2^52 / p) << 32, and the
// multiples of p just above 2^50 and 2^42.
__device__ __forceinline__ Mod load_mod(const longlong2* __restrict__ mods, int64_t g) {
    const longlong2 a = mods[2 * g], b = mods[2 * g + 1];
    Mod c;
    c.p = (uint32_t)a.x;
    c.p2 = 2u * c.p;
    c.r32 = (uint32_t)((uint64_t)a.x >> 32);
    c.r32sh = (uint32_t)a.y;
    c.m52 = (uint32_t)((uint64_t)a.y >> 32);
    c.offl = b.x;
    c.offh = b.y;
    return c;
}

// x < 2^52  ->  a value in [0, 3p) congruent to x
__device__ __forceinline__ uint32_t red52(uint64_t x, const Mod& c) {
    const uint32_t q = __umulhi((uint32_t)(x >> 20), c.m52);
    return (uint32_t)x - q * c.p;
}

// sum_k S_k 256^k mod p, canonical
__device__ __forceinline__ uint32_t recombine(const int (&s)[7], const Mod& c) {
    const int64_t low = (int64_t)s[0] + (int64_t)s[1] * 256 + (int64_t)s[2] * 65536
                        + (int64_t)s[3] * 16777216;
    const int64_t high = (int64_t)s[4] + (int64_t)s[5] * 256 + (int64_t)s[6] * 65536;
    const uint32_t h = red52((uint64_t)(high + c.offh), c);          // [0, 3p)
    const uint32_t hr = h * c.r32 - __umulhi(h, c.r32sh) * c.p;      // [0, 2p)
    uint32_t l = red52((uint64_t)(low + c.offl), c);                 // [0, 3p)
    if (l >= c.p2) l -= c.p2;                                        // [0, 2p)
    uint32_t v = hr + l;                                             // [0, 4p)
    if (v >= c.p2) v -= c.p2;
    if (v >= c.p) v -= c.p;
    return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
    return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The data operand of one stage: DSIDE rows (or columns) x BK depth, as units
// of four consecutive k of one row.
template <int NT, bool DATA_A, bool FIRST>
struct DataTile {
    using DT = typename std::conditional<FIRST, int64_t, uint32_t>::type;
    static constexpr int KQ = BK / 4;                    // units along k
    static constexpr int UPT = DSIDE * KQ / NT;          // units per thread
    uint32_t v[UPT][4];

    // unit u -> row of the data side, and which four k
    static __device__ __forceinline__ void pos(int u, int& row, int& kq) {
        if (DATA_A) {
            // consecutive threads read consecutive k of one row
            row = u / KQ;
            kq = u % KQ;
        } else {
            // a warp reads 4 k-quads x 8 consecutive columns
            const int lane = u & 31, w = u >> 5;
            row = (w & 3) * 8 + (lane & 7);
            kq = (w >> 2) * 4 + (lane >> 3);
        }
    }

    // `plane`: [M, K] with ld = K (DATA_A) or [K, N] with ld = N; `side0`: first
    // row (DATA_A) or column of the block's tile
    __device__ __forceinline__ void load(const DT* plane, int ld, int side0, int k0, int tid) {
#pragma unroll
        for (int j = 0; j < UPT; ++j) {
            int row, kq;
            pos(tid + j * NT, row, kq);
            if (DATA_A) {
                const DT* src = plane + (int64_t)(side0 + row) * ld + k0 + 4 * kq;
                if (FIRST) {
                    const longlong2 a = *reinterpret_cast<const longlong2*>(src);
                    const longlong2 b = *reinterpret_cast<const longlong2*>(src + 2);
                    v[j][0] = (uint32_t)a.x; v[j][1] = (uint32_t)a.y;
                    v[j][2] = (uint32_t)b.x; v[j][3] = (uint32_t)b.y;
                } else {
                    const uint4 a = *reinterpret_cast<const uint4*>(src);
                    v[j][0] = a.x; v[j][1] = a.y; v[j][2] = a.z; v[j][3] = a.w;
                }
            } else {
                const DT* src = plane + (int64_t)(k0 + 4 * kq) * ld + side0 + row;
#pragma unroll
                for (int e = 0; e < 4; ++e) v[j][e] = (uint32_t)src[(int64_t)e * ld];
            }
        }
    }

    // split into digits and store into the stage's data region (4 planes of
    // DSIDE rows of ROWB bytes)
    __device__ __forceinline__ void store(unsigned char* region, int tid) const {
#pragma unroll
        for (int j = 0; j < UPT; ++j) {
            int row, kq;
            pos(tid + j * NT, row, kq);
            uint32_t w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) w[e] = (v[j][e] + BIAS) ^ BIAS;
            // byte i of w[e] is digit i of element e; transpose the 4 x 4 bytes
            const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
            const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
            const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
            const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
            unsigned char* dst = region + row * ROWB + kq * 4;
            *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t2, 0x5410);
            *reinterpret_cast<uint32_t*>(dst + DSIDE * ROWB) = __byte_perm(t0, t2, 0x7632);
            *reinterpret_cast<uint32_t*>(dst + 2 * DSIDE * ROWB) = __byte_perm(t1, t3, 0x5410);
            *reinterpret_cast<uint32_t*>(dst + 3 * DSIDE * ROWB) = __byte_perm(t1, t3, 0x7632);
        }
    }
};

constexpr int PRODUCERS = 128;      // one warpgroup fetches, the others multiply

// named barriers 1 .. 2 NSTAGE: stage s is full, stage s is empty
__device__ __forceinline__ void bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// one bulk copy of `bytes` from device memory into shared memory; `mbar` learns
// of its completion
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t mbar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(mbar), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 :: "r"(dst), "l"(src), "r"(bytes), "r"(mbar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
    } while (!done);
}

// C[z] = A[z] @ B[z] mod p, z = b * L + l; FIRST: then * T mod p (Shoup), from
// int64 data to u32; else from u32 data to int64.
// DATA_A: A is data [M, K], B is the table (tiled digit planes of its [N, K]).
// else:   A is the table (tiled digit planes of its [M, K]), B is data [K, N].
// Blocks are persistent: block b takes output tiles b, b + gridDim.x, ..., and
// its ring of stages runs on across tile boundaries.  Warps 0-3 are producers:
// one bulk copy brings a stage of the table, the threads load and split the
// data, and they never multiply; the NW consumer warps only multiply and
// reduce.  A stage passes between them through an mbarrier (the table has
// landed) and two named barriers (the data is stored; the stage is free), so
// the products of one step overlap the fetching of the next ones without any
// block-wide barrier.
template <int NW, bool DATA_A, bool FIRST>
__global__ void __launch_bounds__(PRODUCERS + NW * 32, 1)
modmm_kernel(const void* __restrict__ data_, const int8_t* __restrict__ tab,
             void* __restrict__ out_, const uint2* __restrict__ tw,
             const longlong2* __restrict__ mods, const int64_t* __restrict__ limbs,
             int M, int N, int K, int L, int tiles) {
    using Tile = DataTile<PRODUCERS, DATA_A, FIRST>;
    using DT = typename Tile::DT;
    using OT = typename std::conditional<FIRST, uint32_t, int64_t>::type;
    constexpr int THREADS = PRODUCERS + NW * 32;
    constexpr int TT = 16 * NW;                        // rows of the table operand in a tile
    constexpr int TAB_BYTES = 4 * TT * ROWB;
    constexpr int STAGE_BYTES = TAB_BYTES + 4 * DSIDE * ROWB;
    constexpr int AROWS = DATA_A ? DSIDE : TT;
    constexpr int BROWS = DATA_A ? TT : DSIDE;
    constexpr int FULL = 1, EMPTY = 1 + NSTAGE;        // first ids of the named barriers

    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ __align__(8) uint64_t landed[NSTAGE];   // mbarriers: a stage's table has landed

    const int tid = threadIdx.x, lane = tid & 31;
    const int R = DATA_A ? N : M, D = DATA_A ? M : N;  // the table's rows, the data's
    const int tiles_t = R / TT, tiles_d = D / DSIDE;
    const int KT = K / BK;
    const int64_t plane_elems = (int64_t)M * N;        // the table is square: data and output alike

    if (tid == 0) {
#pragma unroll
        for (int s = 0; s < NSTAGE; ++s)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                         :: "r"(smem_u32(&landed[s])) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // output tile `id` -> plane, limb, table tile, first data row / column;
    // table tiles vary fastest, so blocks that run together share a data tile
    struct Ref { int z, tt, d0; int64_t g; };
    auto ref_of = [&](int id) {
        Ref r;
        r.tt = id % tiles_t;
        r.d0 = ((id / tiles_t) % tiles_d) * DSIDE;
        r.z = id / (tiles_t * tiles_d);
        r.g = limbs[r.z % L];
        return r;
    };
    // flattened steps f = (local tile, k step)
    const int my_tiles = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
    const int steps = my_tiles * KT;
    auto tile_of = [&](int f) { return (int)blockIdx.x + (f / KT) * (int)gridDim.x; };

    if (tid < PRODUCERS) {
        const int ld = DATA_A ? K : N;
        Ref rp = ref_of(tile_of(0));                    // the tile of the step being fetched
        int kp = 0;                                     // its k step
        // iteration i: fetch step i (its table stage by one bulk copy, its data
        // into `mine`), then split and store the data of step i - 1 (`prev`,
        // loaded one iteration ago) and announce it; two register sets take
        // turns, so no load is waited for early
        auto fetch = [&](int i, Tile& mine, Tile& prev) {
            if (i < steps) {
                if (i >= NSTAGE) bar_sync(EMPTY + i % NSTAGE, THREADS);
                if (tid == 0)
                    bulk_copy(smem_u32(smem + (i % NSTAGE) * STAGE_BYTES),
                              tab + (((rp.g * tiles_t + rp.tt) * KT) + kp) * TAB_BYTES,
                              TAB_BYTES, smem_u32(&landed[i % NSTAGE]));
                mine.load(reinterpret_cast<const DT*>(data_) + rp.z * plane_elems, ld, rp.d0,
                          kp * BK, tid);
                if (++kp == KT) {
                    kp = 0;
                    if (i + 1 < steps) rp = ref_of(tile_of(i + 1));
                }
            }
            if (i >= 1 && i - 1 < steps) {
                prev.store(smem + ((i - 1) % NSTAGE) * STAGE_BYTES + TAB_BYTES, tid);
                bar_arrive(FULL + (i - 1) % NSTAGE, THREADS);
            }
        };
        Tile even, odd;
        for (int i = 0; i < steps + 1; i += 2) {
            fetch(i, even, odd);
            fetch(i + 1, odd, even);
        }
        return;
    }

    const int warp = (tid - PRODUCERS) >> 5;            // consumer warp
    // this warp's 32 x 16 outputs inside the block tile
    const int wrow = DATA_A ? 0 : (warp >> 1) * 32;
    const int wcol = DATA_A ? warp * 16 : (warp & 1) * 16;
    // ldmatrix row addresses: A as four 8 x 16-byte matrices (rows 0-7 / 8-15,
    // k 0-15 / 16-31), B as (n 0-7 / 8-15) x (k 0-15 / 16-31)
    const int a_off = (wrow + (lane & 7) + ((lane >> 3) & 1) * 8) * ROWB + (lane >> 4) * 16;
    const int b_off = (wcol + (lane & 7) + (lane >> 4) * 8) * ROWB + ((lane >> 3) & 1) * 16;
    const int a_reg = DATA_A ? TAB_BYTES : 0;           // byte offset of A's region in a stage
    const int b_reg = DATA_A ? 0 : TAB_BYTES;

    int acc[2][2][7][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int k = 0; k < 7; ++k)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][k][e] = 0;

    for (int f = 0; f < steps; ++f) {
        bar_sync(FULL + f % NSTAGE, THREADS);                          // the data's digits
        mbar_wait(smem_u32(&landed[f % NSTAGE]), (f / NSTAGE) & 1);    // the table's
        const uint32_t st = smem_u32(smem + (f % NSTAGE) * STAGE_BYTES);
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks) {
            uint32_t a[4][2][4];
#pragma unroll
            for (int d = 0; d < 4; ++d)
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
                    ldmatrix4(a[d][mt], st + a_reg + (d * AROWS + mt * 16) * ROWB + a_off + ks * 32);
#pragma unroll
            for (int dj = 0; dj < 4; ++dj) {
                uint32_t b[4];      // {nt 0: k lo, k hi; nt 1: k lo, k hi}
                ldmatrix4(b, st + b_reg + dj * BROWS * ROWB + b_off + ks * 32);
#pragma unroll
                for (int di = 0; di < 4; ++di)
#pragma unroll
                    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                        for (int nt = 0; nt < 2; ++nt)
                            mma_s8(acc[mt][nt][di + dj], a[di][mt], b[2 * nt], b[2 * nt + 1]);
            }
        }
        // this warp has read all it needs of the stage
        if (f + NSTAGE < steps) bar_arrive(EMPTY + f % NSTAGE, THREADS);

        if (f % KT != KT - 1) continue;
        // epilogue of a tile: a thread holds rows g, g + 8 and columns 2t, 2t + 1
        // of each 16 x 8 tile
        const Ref r = ref_of(tile_of(f));
        const Mod mod = load_mod(mods, r.g);
        const int m0 = DATA_A ? r.d0 : r.tt * TT, n0 = DATA_A ? r.tt * TT : r.d0;
        OT* outp = reinterpret_cast<OT*>(out_) + r.z * plane_elems;
        const uint2* twp = FIRST ? tw + r.g * plane_elems : nullptr;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = m0 + wrow + mt * 16 + (lane >> 2) + 8 * h;
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                    const int col = n0 + wcol + nt * 8 + 2 * (lane & 3);
                    const int64_t off = (int64_t)row * N + col;
                    uint32_t v[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        int s[7];
#pragma unroll
                        for (int k = 0; k < 7; ++k) {
                            s[k] = acc[mt][nt][k][2 * h + e];
                            acc[mt][nt][k][2 * h + e] = 0;
                        }
                        v[e] = recombine(s, mod);
                    }
                    if (FIRST) {
                        // Shoup: v * t mod p with tsh = floor(t * 2^32 / p)
                        const uint4 t = *reinterpret_cast<const uint4*>(twp + off);
                        uint32_t r0 = v[0] * t.x - __umulhi(v[0], t.y) * mod.p;
                        uint32_t r1 = v[1] * t.z - __umulhi(v[1], t.w) * mod.p;
                        if (r0 >= mod.p) r0 -= mod.p;
                        if (r1 >= mod.p) r1 -= mod.p;
                        *reinterpret_cast<uint2*>(outp + off) = make_uint2(r0, r1);
                    } else {
                        *reinterpret_cast<longlong2*>(outp + off) =
                            make_longlong2((long long)v[0], (long long)v[1]);
                    }
                }
            }
    }
}

constexpr int MAX_DEVICES = 64;     // what is remembered per device, by its ordinal

int current_device() {
    int dev = 0;
    return cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < MAX_DEVICES ? dev : -1;
}

int sm_count(int dev) {
    static int n[MAX_DEVICES] = {};
    if (!n[dev] &&
        (cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
         n[dev] < 1))
        n[dev] = 1;
    return n[dev];
}

template <int NW, bool DATA_A, bool FIRST>
int launch(const void* data, const int8_t* tab, void* out, const uint2* tw,
           const longlong2* mods, const int64_t* limbs, int M, int N, int K, int L,
           int batch, cudaStream_t stream) {
    constexpr int TT = 16 * NW;
    constexpr int SMEM = NSTAGE * (4 * TT + 4 * DSIDE) * ROWB;
    static bool ready[MAX_DEVICES] = {};
    auto kern = modmm_kernel<NW, DATA_A, FIRST>;
    const int dev = current_device();
    if (dev < 0) return (int)cudaErrorInvalidDevice;
    if (!ready[dev]) {
        cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
        if (e != cudaSuccess) return (int)e;
        ready[dev] = true;
    }
    const int R = DATA_A ? N : M, D = DATA_A ? M : N;
    const long long tiles = (long long)(R / TT) * (D / DSIDE) * batch * L;
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int grid = tiles < sm_count(dev) ? (int)tiles : sm_count(dev);     // one block an SM
    kern<<<grid, PRODUCERS + NW * 32, SMEM, stream>>>(data, tab, out, tw, mods, limbs, M, N, K, L, (int)tiles);
    return (int)cudaGetLastError();
}

template <bool DATA_A, bool FIRST>
int launch_nw(int nw, const void* data, const int8_t* tab, void* out, const uint2* tw,
              const longlong2* mods, const int64_t* limbs, int M, int N, int K, int L,
              int batch, cudaStream_t stream) {
    return nw == 8
        ? launch<8, DATA_A, FIRST>(data, tab, out, tw, mods, limbs, M, N, K, L, batch, stream)
        : launch<4, DATA_A, FIRST>(data, tab, out, tw, mods, limbs, M, N, K, L, batch, stream);
}

}  // namespace

// One modular matmul of every plane.  data_a: the data is the left operand
// [M, K] and `tab` holds the tiled digit planes of the table's [N, K]; else the
// data is the right operand [K, N] and `tab` holds those of its [M, K].  first: int64 data in,
// twiddle `tw` [Ltot, M, N] of packed (t, tsh) applied, u32 out; else u32 data
// in, int64 out.  `mods` [Ltot, 4] holds each prime's reduction constants.
extern "C" int fs_modmm(const void* data, const void* tab, void* out, const void* tw,
                        const void* mods, const int64_t* limbs,
                        int M, int N, int K, int L, int batch,
                        int data_a, int first, void* stream) {
    const int R = data_a ? N : M, D = data_a ? M : N;
    if (R % 64 || R != K || D % DSIDE || K % BK || K > MAX_K || (K & (K - 1)) || L < 1 || batch < 1 ||
        (first && !tw))
        return (int)cudaErrorInvalidValue;
    const int nw = R % 128 == 0 ? 8 : 4;
    const int8_t* t8 = (const int8_t*)tab;
    const uint2* t2 = (const uint2*)tw;
    const longlong2* mq = (const longlong2*)mods;
    cudaStream_t s = (cudaStream_t)stream;
    if (data_a)
        return first ? launch_nw<true, true>(nw, data, t8, out, t2, mq, limbs, M, N, K, L, batch, s)
                     : launch_nw<true, false>(nw, data, t8, out, t2, mq, limbs, M, N, K, L, batch, s);
    return first ? launch_nw<false, true>(nw, data, t8, out, t2, mq, limbs, M, N, K, L, batch, s)
                 : launch_nw<false, false>(nw, data, t8, out, t2, mq, limbs, M, N, K, L, batch, s);
}
