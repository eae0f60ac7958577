// The closure kernels: K1, K2 and K3 (one closure body, three epilogues)
// and K4 (the shards' fold and the filter), hand-written for Hopper
// (sm_90a), one source and one build.
//
// K1 — the batched closure.
//
// Replaces: src/repro/kernels/closure.py:closure_pallas (body
// _closure_kernel, _tree_and).  Per object shard k and candidate b:
//   closure[k, b] = AND of shard k's matching rows  (identity 0xFFFFFFFF)
//   support[k, b] = number of shard k's matching rows
// raw: not masked to the real attributes, not corrected for padding rows
// (ops.batched_closure does both).  This is K3 without its mask: K1's
// launcher passes K3's a null mask, which the epilogues read as all ones.
//
// K2 — the fused frontier step (closure → support → driver filter).
//
// Replaces: src/repro/kernels/frontier.py:fused_closure_call (body
// _fused_kernel, _keep_mask, _row_valid).  K1's closure followed by the
// epilogue of _fused_kernel, per candidate b of the chunk:
//   closure[b] = (AND of matching rows) & mask
//   support[b] = matches - n_pad
//   keep[b]    = (b + row_off < n_valid)
//                && (!ICEBERG || support[b] >= min_sup)
//                && (!CBO || ((closure[b] ^ parent[b]) & lowrow[b]) == 0)
// n_valid, min_sup, n_pad and row_off are plain int launch arguments, so
// no threshold or window forces a rebuild; ICEBERG and CBO are template
// parameters.  n_valid may come from the device instead (n_valid_dev, a
// nullable int pointer): the count an earlier kernel left there, read
// before the keep test, so that a speculative round chains on its
// predecessor's survivor count with no host read between them.  CbO's
// LOW[gen] gather stays outside the kernel, as in the reference engine
// (lowrow = LOW[gens]).
//
// K3 — the map half of a multi-shard round.
//
// Replaces: src/repro/kernels/frontier.py:map_closure_call (body
// _map_kernel).  Per object shard k and candidate b:
//   closure[k, b] = (AND of shard k's matching rows) & mask
//   support[k, b] = number of shard k's matching rows     (raw)
// One launch covers every shard of a simulated plan's [K, N, W] rows, the
// counterpart of jax.vmap batching the Pallas grid; a process-group rank
// launches it with K = 1 on its own slice.  No pad correction here: the
// all-ones pad rows sit in the last shard and are subtracted once, after
// the support sum.
//
// What bounds K1-K3 on the H100.  As a bitwise AND-reduction on the int32
// pipes (16.7 T ops/s): ~(2W + 4) operations per (candidate, row) pair.
// The same function is two 0/1 matrix products over complement bit-planes
// (the reference's closure_matmul, "Perf C2"), exact in integers:
//   R̄ = complement of the unpacked rows (u8 0/1), C = unpacked candidates
//   miss   = C · R̄ᵀ     (s32)   match = (miss == 0) && (row index < N)
//   absent = match · R̄  (s32)   closure bit = (absent == 0); support = Σ match
// 2 · 2 · B · rows · 32W operations, on the int8 tensor cores at 1,979
// TOPS: the bound of both routes is of the same order, but only this one
// leaves the integer pipes free for the unpacking.  miss <= 32W and
// absent <= N fit s32, so any accumulation order gives the same bits.
//
// What the design does about it: closure_tc_kernel below, for W <=
// TCF_MAX_W words; wider rows take the SIMT body (closure_accumulate
// below), chosen by W alone in the launchers.
//   * One CTA owns 128 candidates (two consumer warpgroups of 64) and a
//     range of rows of one shard; a producer warpgroup feeds a ring of
//     64-row stages.  The candidates' plane C is unpacked once per CTA.
//   * The producer reads each packed row tile from device memory into
//     registers a tile ahead (W words a row: the SM-side traffic stays at
//     the packed size) and expands it in shared memory into the two
//     complement planes the wgmma descriptors name: R̄ [64 rows][32W lanes],
//     lanes K-major with the 128-byte swizzle, for miss; R̄ᵀ [32W lanes][64
//     rows], rows K-major with the 64-byte swizzle, for absent (u8 wgmma has
//     no transposed operand), from a word-major copy of the packed tile.
//     Rows past the range are not read: their complement is 0 (all-ones
//     rows), and their matches are masked out by index.
//   * miss: W wgmma m64n64k32 (u8, both operands from shared memory).
//     match stays in registers: the s32 accumulator's columns 8j + 2q + e
//     of a thread (q = lane % 4) become the A operand of absent when the
//     64 rows of the k dimension are taken in the order
//       k = 32kk + 16h + 4q + t  <->  row 8(4kk + 2h + t/2) + 2q + t%2,
//     in which a thread's A bytes are exactly its accumulator columns; the
//     producer writes R̄ᵀ's k-slots in the same order.  absent: per word w,
//     two wgmma m64n32k32 (u8, A from registers), accumulated over every
//     tile.  support: the popcount of the thread's match bytes, summed
//     over the quad at the end.
//   * Epilogue: absent == 0 packed into words across the quad that holds
//     a candidate's columns, ANDed with mask (K2, K3; K1 has none) and
//     written; K2 then runs the keep test on the written words.
//   * Filling the card: where (candidate tiles x shards) leave SMs idle,
//     the launcher splits the row axis (row_split; K1 at B = 8 or 64
//     against 8192 rows: 128 CTAs of one 64-row tile); partial closures
//     then combine by atomicAnd and supports by atomicAdd on outputs set to
//     their identities first (exact in any order), and for K2 the last
//     CTA of a candidate tile (an arrival counter in wrapper scratch)
//     runs the keep test.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// ---------------------------------------------------------------------------
// The SIMT closure body, which K1, K2 and K3 take for rows wider than
// TCF_MAX_W words (for W <= TCF_MAX_W they take the tensor-core body
// below).
//
// Bitsets are uint32 words (PyTorch stores them as int32; the bits are the
// same).  A CTA owns CLOSURE_GROUP consecutive candidates and walks every
// context row in tiles of blockDim.x rows, one row per thread:
//
//   1. each thread tests its row against each candidate
//      (match = all_w((row & cand) == cand), early exit on the first word
//      that fails) and the warp ballots the match bits;
//   2. for every candidate with a match in the warp, the warp ANDs the
//      matching rows word by word with __reduce_and_sync (non-matching
//      lanes contribute the identity 0xFFFFFFFF) and counts the matches
//      with __popc of the ballot; lane 0 folds both into the CTA's
//      accumulators in shared memory with shared-memory atomics.
//
// The row loop inside the CTA takes the place of the TPU kernel's
// sequential N grid axis; nothing carries over between CTAs, so every CTA
// writes its own candidates' outputs and no cross-CTA pass is needed.
// Candidate words and accumulators live in dynamic shared memory:
// (2 * CLOSURE_GROUP * W + 2 * CLOSURE_GROUP) words, which bounds W by the
// card's shared memory per block (3631 words, 116,192 attributes, under the
// H100's 227 KB); frontier_simt_max_w() gives the bound of the card in use,
// and the Python wrappers raise above it.

#define CLOSURE_THREADS 256
#define CLOSURE_GROUP 8
#define FULL_WORD 0xffffffffu

// Bytes of dynamic shared memory one CTA needs for word width W.
static inline size_t closure_smem_bytes(int W) {
    return (size_t)(2 * CLOSURE_GROUP * W + 2 * CLOSURE_GROUP) * sizeof(uint32_t);
}

struct ClosureSmem {
    uint32_t* cand;  // [CLOSURE_GROUP * W] the CTA's candidates
    uint32_t* acc;   // [CLOSURE_GROUP * W] AND of the matching rows
    unsigned* sup;   // [CLOSURE_GROUP]     number of matching rows
    unsigned* flag;  // [CLOSURE_GROUP]     epilogue scratch (fused step)
};

// Carve the shared buffers and load the CTA's candidates; initialise the
// accumulators to the AND identity and the counts to zero.
__device__ __forceinline__ ClosureSmem closure_setup(
    uint32_t* smem, const uint32_t* __restrict__ cands, int b0, int G, int W)
{
    ClosureSmem s;
    s.cand = smem;
    s.acc = smem + CLOSURE_GROUP * W;
    s.sup = smem + 2 * CLOSURE_GROUP * W;
    s.flag = s.sup + CLOSURE_GROUP;
    const uint32_t* src = cands + (size_t)b0 * W;
    for (int i = threadIdx.x; i < G * W; i += blockDim.x) {
        s.cand[i] = src[i];
        s.acc[i] = FULL_WORD;
    }
    for (int i = threadIdx.x; i < CLOSURE_GROUP; i += blockDim.x) {
        s.sup[i] = 0u;
        s.flag[i] = 0u;
    }
    __syncthreads();
    return s;
}

// Fold every matching row of rows[N, W] into s.acc / s.sup for the CTA's
// G candidates.  Every lane of a warp runs the same number of iterations
// (the row bound is a predicate, not a loop exit), as the warp-wide
// ballot and reductions require.
__device__ __forceinline__ void closure_accumulate(
    const uint32_t* __restrict__ rows, int N, int W, int G, ClosureSmem s)
{
    const int lane = threadIdx.x & 31;
    for (int base = 0; base < N; base += blockDim.x) {
        const int row = base + threadIdx.x;
        const bool in = row < N;
        const uint32_t* r = rows + (size_t)(in ? row : 0) * W;
        for (int g = 0; g < G; ++g) {
            const uint32_t* c = s.cand + g * W;
            bool m = in;
            for (int w = 0; m && w < W; ++w) {
                const uint32_t cw = c[w];
                m = (__ldg(r + w) & cw) == cw;
            }
            const unsigned ballot = __ballot_sync(FULL_WORD, m);
            if (ballot == 0u) continue;  // uniform across the warp
            if (lane == 0) atomicAdd(s.sup + g, (unsigned)__popc(ballot));
            for (int w = 0; w < W; ++w) {
                const uint32_t v = m ? __ldg(r + w) : FULL_WORD;
                const uint32_t folded = __reduce_and_sync(FULL_WORD, v);
                if (lane == 0) atomicAnd(s.acc + g * W + w, folded);
            }
        }
    }
    __syncthreads();
}

// Allow more than 48 KB of dynamic shared memory where W needs it.
template <typename Kernel>
static inline cudaError_t closure_smem_attr(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The SIMT epilogues: K2's on the shared accumulators, K3's (and K1's) plain.

template <bool ICEBERG, bool CBO>
__global__ void __launch_bounds__(CLOSURE_THREADS)
fused_step_kernel(const uint32_t* __restrict__ rows,
                  const uint32_t* __restrict__ cands,
                  const uint32_t* __restrict__ mask,
                  const uint32_t* __restrict__ parent,
                  const uint32_t* __restrict__ lowrow,
                  uint32_t* __restrict__ out_c,
                  int* __restrict__ out_s,
                  uint8_t* __restrict__ keep,
                  const int* __restrict__ n_valid_dev,
                  int N, int B, int W,
                  int n_valid, int min_sup, int n_pad, int row_off)
{
    extern __shared__ uint32_t smem[];
    if (n_valid_dev != nullptr) n_valid = __ldg(n_valid_dev);
    const int b0 = blockIdx.x * CLOSURE_GROUP;
    const int G = min(CLOSURE_GROUP, B - b0);
    ClosureSmem s = closure_setup(smem, cands, b0, G, W);
    closure_accumulate(rows, N, W, G, s);
    for (int i = threadIdx.x; i < G * W; i += blockDim.x) {
        const size_t o = (size_t)b0 * W + i;
        const uint32_t gc = s.acc[i] & mask[i % W];
        out_c[o] = gc;
        if (CBO && ((gc ^ parent[o]) & lowrow[o]) != 0u)
            atomicOr(s.flag + i / W, 1u);  // not canonical
    }
    __syncthreads();
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
        const int b = b0 + g;
        const int sup = (int)s.sup[g] - n_pad;
        out_s[b] = sup;
        bool k = b + row_off < n_valid;
        if (ICEBERG) k = k && sup >= min_sup;
        if (CBO) k = k && s.flag[g] == 0u;
        keep[b] = k ? 1 : 0;
    }
}

__global__ void __launch_bounds__(CLOSURE_THREADS)
map_closure_kernel(const uint32_t* __restrict__ rows,
                   const uint32_t* __restrict__ cands,
                   const uint32_t* __restrict__ mask,
                   uint32_t* __restrict__ out_c,
                   int* __restrict__ out_s,
                   int N, int B, int W)
{
    extern __shared__ uint32_t smem[];
    const size_t shard = blockIdx.y;
    rows += shard * N * W;
    out_c += shard * B * W;
    out_s += shard * B;
    const int b0 = blockIdx.x * CLOSURE_GROUP;
    const int G = min(CLOSURE_GROUP, B - b0);
    ClosureSmem s = closure_setup(smem, cands, b0, G, W);
    closure_accumulate(rows, N, W, G, s);
    for (int i = threadIdx.x; i < G * W; i += blockDim.x)
        out_c[(size_t)b0 * W + i] = mask ? s.acc[i] & mask[i % W] : s.acc[i];
    for (int i = threadIdx.x; i < G; i += blockDim.x)
        out_s[b0 + i] = (int)s.sup[i];
}

// ---------------------------------------------------------------------------
// The tensor-core body (W <= TCF_MAX_W)
//
// CTA = 3 warpgroups (384 threads): warpgroups 0 and 1 consume, each owning
// 64 candidates (the second leaves at once where the tile has no
// candidates past 64); warpgroup 2 produces (setmaxnreg: 224 / 48).
// blockIdx = (candidate tile, row split, shard).
//
// Shared memory (1024-byte aligned): C [2][NBOX][64][128 B]; STAGES stages
// of R̄ [NBOX][64][128 B] and R̄ᵀ [32W][64 B]; two slots of a staged packed
// tile [W][TCF_PK] words; full[STAGES] and empty[STAGES] mbarriers.  A
// plane row of 32W lane bytes spans NBOX = ceil(W / 4) boxes of 128 bytes
// (the 128-byte swizzle atom); the lanes past 32W in the last box are
// never read.
// ---------------------------------------------------------------------------

#define TCF_MAX_W 10     // widest word count of the tensor body
#define TCF_CANDS 128    // candidates of one CTA
#define TCF_ROWS 64      // context rows of one stage
#define TCF_THREADS 384  // two consumer warpgroups and one producer warpgroup
#define TCF_BOX 8192     // one box: 64 plane rows of 128 bytes
#define TCF_PK 68        // staged words of one word column (64 rows; +4 spreads banks)

template <int W> struct Tcf {
    static constexpr int NBOX = (W + 3) / 4;
    static constexpr int CPLANE = 2 * NBOX * TCF_BOX;         // candidates
    static constexpr int RPLANE = NBOX * TCF_BOX;             // R̄ of a stage
    static constexpr int TPLANE = 32 * W * TCF_ROWS;          // R̄ᵀ of a stage
    static constexpr int STAGE = RPLANE + TPLANE;
    static constexpr int STAGES = W <= 8 ? 4 : 3;
    static constexpr int PACKED = W * TCF_PK * 4;  // one slot of the staged packed tile
    // 169,280 bytes at W 8 (four stages), 190,832 at W 10 (three), under
    // the 227 KB one CTA may take
    static constexpr size_t SMEM =
        1024 + CPLANE + (size_t)STAGES * STAGE + 2 * PACKED + 16 * STAGES;
};

struct TcfArgs {
    const uint32_t* rows;    // [K][N][W]
    const uint32_t* cands;   // [B][W]
    const uint32_t* mask;    // [W], or null (K1: raw closures)
    const uint32_t* parent;  // [B][W] (CbO)
    const uint32_t* lowrow;  // [B][W] (CbO)
    uint32_t* out_c;         // [K][B][W]
    int* out_s;              // [K][B]
    uint8_t* keep;           // [B] (K2)
    int* arrived;            // [candidate tiles] (K2 with a row split)
    const int* n_valid_dev;  // the valid count on the device, or null: n_valid (K2)
    int N, B, n_valid, min_sup, n_pad, row_off;
    int tps, nsplit;         // row tiles of one split, splits
};

// bits 0-3 of x as the bytes 0/1 of a word
__device__ __forceinline__ uint32_t spread_nibble(uint32_t x)
{
    return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

// lanes 32w .. 32w + 31 (bit l of x: lane 32w + l) of plane row `row` as
// bytes 0/1, into a [NBOX][64][128 B] plane with the 128-byte swizzle (the
// 16-byte chunk index XOR the row index mod 8)
__device__ __forceinline__ void put_lanes(uint32_t plane, int row, int w, uint32_t x)
{
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int l = 32 * w + 16 * h;
        const uint32_t addr =
            plane + (l >> 7) * TCF_BOX + row * 128 + ((((l & 127) >> 4) ^ (row & 7)) << 4);
        const uint32_t y = x >> (16 * h);
        st_shared_v4(addr, spread_nibble(y), spread_nibble(y >> 4), spread_nibble(y >> 8),
                     spread_nibble(y >> 12));
    }
}

// the zero test of four s32 values >= 0 as the bytes 0/1 of a word
__device__ __forceinline__ uint32_t zero_bytes(uint32_t d0, uint32_t d1, uint32_t d2, uint32_t d3)
{
    const uint32_t lo = __byte_perm(min(d0, 1u), min(d1, 1u), 0x0040);
    const uint32_t hi = __byte_perm(min(d2, 1u), min(d3, 1u), 0x0040);
    return __byte_perm(lo, hi, 0x5410) ^ 0x01010101u;
}

// The products.  miss (+)= C.R̄ᵀ: m64n64k32, both operands K-major in shared
// memory (128-byte swizzle).  absent += match.R̄: m64n32k32, match from
// registers, R̄ᵀ K-major in shared memory (64-byte swizzle).
#define WG_R4(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define WG_R8(d, i) WG_R4(d, i), WG_R4(d, i + 4)
#define WG_R16(d, i) WG_R8(d, i), WG_R8(d, i + 8)
#define WG_R32(d, i) WG_R16(d, i), WG_R16(d, i + 16)

__device__ __forceinline__ void wgmma_miss(uint32_t (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p;\n}\n"
        : WG_R32(d, 0)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_absent(uint32_t (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p;\n}\n"
        : WG_R16(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int W, bool FUSED, bool ICEBERG, bool CBO>
__global__ void __launch_bounds__(TCF_THREADS, 1) closure_tc_kernel(const TcfArgs a)
{
    using C = Tcf<W>;
    extern __shared__ unsigned char tcf_smem[];
    __shared__ int last_cta;
    const uint32_t c_sm = (smem_u32(tcf_smem) + 1023u) & ~1023u;  // [2][RPLANE]
    const uint32_t st_sm = c_sm + C::CPLANE;                       // [STAGES][STAGE]
    const uint32_t pk_sm = st_sm + C::STAGES * C::STAGE;           // [2][W][TCF_PK]
    const uint32_t full = pk_sm + 2 * C::PACKED;                   // + 8 s
    const uint32_t empty = full + 8 * C::STAGES;                   // + 8 s

    const int tile = blockIdx.x, shard = blockIdx.z;
    const int b0 = tile * TCF_CANDS;
    const int r_lo = blockIdx.y * a.tps * TCF_ROWS;
    const int r_hi = min(a.N, r_lo + a.tps * TCF_ROWS);
    const int ntiles = r_hi > r_lo ? (r_hi - r_lo + TCF_ROWS - 1) / TCF_ROWS : 0;
    const bool act1 = b0 + 64 < a.B;  // the second warpgroup has candidates
    const int consumers = 128 * (1 + act1);
    const uint32_t* rows = a.rows + (size_t)shard * a.N * W;
    uint32_t* out_c = a.out_c + (size_t)shard * a.B * W;
    int* out_s = a.out_s + (size_t)shard * a.B;

    const int tid = threadIdx.x;
    if (tid == 0) {
#pragma unroll
        for (int s = 0; s < C::STAGES; ++s) {
            mbar_init(full + 8 * s, 128);                 // every producer thread
            mbar_init(empty + 8 * s, consumers / 32);     // every consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // the candidates' plane, once per CTA (candidates past B: zero lanes)
    for (int u = tid; u < TCF_CANDS * W; u += TCF_THREADS) {
        const int g = u / W, w = u - g * W;
        const int b = b0 + g;
        const uint32_t x = b < a.B ? __ldg(a.cands + (size_t)b * W + w) : 0u;
        put_lanes(c_sm + (g >> 6) * C::RPLANE, g & 63, w, x);
    }
    fence_proxy_async();
    __syncthreads();

    if (tid >= 256) {
        // producer warpgroup: unpack each row tile into both planes
        asm volatile("setmaxnreg.dec.sync.aligned.u32 48;\n" ::: "memory");
        const int p = tid - 256;
        // The packed words of a tile: thread p takes row p / 2 of it and the
        // words w = p % 2 + 2j of that row, loaded into registers a tile ahead,
        // complemented (rows past the range as 0: all-ones rows), expanded
        // into R̄, and staged word-major, [W][TCF_PK] in one of two slots, for
        // the R̄ᵀ units.
        constexpr int PRE = (W + 1) / 2;
        const int pr = p >> 1, pw = p & 1;
        const auto load = [&](int i, uint32_t (&v)[PRE]) {
            const int row = r_lo + i * TCF_ROWS + pr;
            if (i < ntiles && row < r_hi) {
                const uint32_t* src = rows + (size_t)row * W + pw;
#pragma unroll
                for (int j = 0; j < PRE; ++j)
                    if (pw + 2 * j < W) v[j] = __ldg(src + 2 * j);
            }
        };
        uint32_t cur[PRE], nxt[PRE];
        load(0, cur);
        for (int i = 0; i < ntiles; ++i) {
            const int s = i % C::STAGES;
            const bool in = r_lo + i * TCF_ROWS + pr < r_hi;
            load(i + 1, nxt);
            if (i >= C::STAGES) mbar_wait(empty + 8 * s, (i / C::STAGES - 1) & 1);
            const uint32_t rb = st_sm + s * C::STAGE, rt = rb + C::RPLANE;
            const uint32_t pk = pk_sm + (i & 1) * C::PACKED;
            // R̄: this thread's (row, word)s, from registers
#pragma unroll
            for (int j = 0; j < PRE; ++j) {
                const int w = pw + 2 * j;
                if (w < W) {
                    const uint32_t x = in ? ~cur[j] : 0u;
                    st_shared_u32(pk + 4 * (w * TCF_PK + pr), x);
                    put_lanes(rb, pr, w, x);
                }
            }
            named_bar_sync(1, 128);  // tile i is staged; the other slot is free
            // R̄ᵀ: one (word w, k-slot chunk c, byte k of the word) each.  Chunk c
            // holds rows 16c .. 16c + 15; its u32 m the rows 16c + {2m, 2m + 1,
            // 8 + 2m, 9 + 2m} (the k order above).  y[m] gathers byte k of those
            // four rows, so lane 8k + beta of the u32 is (y[m] >> beta) & 0x01010101.
            // Neighbouring threads start at different beta, so that one store
            // instruction of a warp covers all eight 16-byte bank groups.
            for (int u = 127 - p; u < 16 * W; u += 128) {
                const int w = u >> 4, c = (u >> 2) & 3, k = u & 3;
                const uint32_t col = pk + 4 * (w * TCF_PK + 16 * c);
                const uint32_t sel = (uint32_t)k | ((uint32_t)(k + 4) << 4);
                uint32_t y[4];
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                    uint32_t x0, x1, x8, x9;  // rows 2m, 2m + 1, 2m + 8, 2m + 9
                    ld_shared_v2(col + 8 * m, x0, x1);
                    ld_shared_v2(col + 8 * m + 32, x8, x9);
                    y[m] = __byte_perm(__byte_perm(x0, x1, sel), __byte_perm(x8, x9, sel), 0x5410);
                }
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int beta = (i + p) & 7;
                    const int l = 32 * w + 8 * k + beta;
                    st_shared_v4(rt + l * 64 + ((c ^ ((l >> 1) & 3)) << 4),
                                 (y[0] >> beta) & 0x01010101u, (y[1] >> beta) & 0x01010101u,
                                 (y[2] >> beta) & 0x01010101u, (y[3] >> beta) & 0x01010101u);
                }
            }
            fence_proxy_async();
            mbar_arrive(full + 8 * s);
#pragma unroll
            for (int j = 0; j < PRE; ++j) cur[j] = nxt[j];
        }
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int wg = tid >> 7;
    if (wg == 1 && !act1) return;
    const int warp = (tid & 127) >> 5, lane = tid & 31, q = lane & 3;
    const int b_0 = b0 + wg * 64 + warp * 16 + (lane >> 2);  // candidates b_0 and b_0 + 8
    const uint64_t cdesc = smem_desc<1>(c_sm + wg * C::RPLANE, 16, 1024);

    uint32_t acc[W][16];
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[w][i] = 0u;
    uint32_t sup0 = 0u, sup1 = 0u;

    for (int i = 0; i < ntiles; ++i) {
        const int s = i % C::STAGES;
        const int n0 = r_lo + i * TCF_ROWS;
        const uint32_t rb = st_sm + s * C::STAGE, rt = rb + C::RPLANE;
        mbar_wait(full + 8 * s, (i / C::STAGES) & 1);

        uint32_t d[32];
        const uint64_t rdesc = smem_desc<1>(rb, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int w = 0; w < W; ++w) {
            const uint32_t off = (w >> 2) * TCF_BOX + (w & 3) * 32;
            wgmma_miss(d, cdesc + (off >> 4), rdesc + (off >> 4), w > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(d);

        // match bytes as the A operand: am[kk][2h + half] byte t is row
        // 8(4kk + 2h + t/2) + 2q + t%2 of candidate b_0 (+ 8 for half 1)
        uint32_t am[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int j = 4 * kk + 2 * h, e = 2 * half;
                    am[kk][2 * h + half] = zero_bytes(d[4 * j + e], d[4 * j + e + 1],
                                                      d[4 * (j + 1) + e], d[4 * (j + 1) + e + 1]);
                }
        if (n0 + TCF_ROWS > r_hi) {  // the range's last tile: rows past it do not match
#pragma unroll
            for (int kk = 0; kk < 2; ++kk)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    uint32_t vm = 0u;
#pragma unroll
                    for (int t = 0; t < 4; ++t) {
                        const int row = n0 + 8 * (4 * kk + 2 * h + (t >> 1)) + 2 * q + (t & 1);
                        vm |= (uint32_t)(row < r_hi) << (8 * t);
                    }
                    am[kk][2 * h] &= vm;
                    am[kk][2 * h + 1] &= vm;
                }
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
            sup0 += __popc(am[kk][0]) + __popc(am[kk][2]);
            sup1 += __popc(am[kk][1]) + __popc(am[kk][3]);
        }

        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int w = 0; w < W; ++w)
                wgmma_absent(acc[w], am[kk], smem_desc<2>(rt + w * 2048 + kk * 32, 16, 512));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int w = 0; w < W; ++w) fence_regs(acc[w]);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // epilogue: closure words (absent == 0 over the quad's columns 8j + 2q + e)
    const bool split = a.nsplit > 1;
    const bool v0 = b_0 < a.B, v1 = b_0 + 8 < a.B;
#pragma unroll
    for (int w = 0; w < W; ++w) {
        uint32_t p0 = 0u, p1 = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                p0 |= (uint32_t)(acc[w][4 * j + e] == 0u) << (8 * j + e);
                p1 |= (uint32_t)(acc[w][4 * j + 2 + e] == 0u) << (8 * j + e);
            }
        p0 <<= 2 * q;
        p1 <<= 2 * q;
        p0 |= __shfl_xor_sync(0xffffffffu, p0, 1);
        p1 |= __shfl_xor_sync(0xffffffffu, p1, 1);
        p0 |= __shfl_xor_sync(0xffffffffu, p0, 2);
        p1 |= __shfl_xor_sync(0xffffffffu, p1, 2);
        if (q == (w & 3)) {
            const uint32_t mw = a.mask ? __ldg(a.mask + w) : FULL_WORD;
            uint32_t* o0 = out_c + (size_t)b_0 * W + w;
            if (split) {
                if (v0) atomicAnd(o0, p0 & mw);
                if (v1) atomicAnd(o0 + 8 * W, p1 & mw);
            } else {
                if (v0) *o0 = p0 & mw;
                if (v1) o0[8 * W] = p1 & mw;
            }
        }
    }
    sup0 += __shfl_xor_sync(0xffffffffu, sup0, 1);
    sup1 += __shfl_xor_sync(0xffffffffu, sup1, 1);
    sup0 += __shfl_xor_sync(0xffffffffu, sup0, 2);
    sup1 += __shfl_xor_sync(0xffffffffu, sup1, 2);
    if (q == 0) {
        if (split) {
            if (v0) atomicAdd(out_s + b_0, (int)sup0);
            if (v1) atomicAdd(out_s + b_0 + 8, (int)sup1);
        } else {
            if (v0) out_s[b_0] = (int)sup0;
            if (v1) out_s[b_0 + 8] = (int)sup1;
        }
    }
    if constexpr (!FUSED) return;

    // K2: the keep test, by the tile's last CTA, on the written words
    if (split) __threadfence();
    named_bar_sync(2, consumers);
    if (split) {
        if (tid == 0) last_cta = atomicAdd(a.arrived + tile, 1) == a.nsplit - 1;
        named_bar_sync(2, consumers);
        if (!last_cta) return;
        __threadfence();
    }
    // the count is read here, not in the prologue, so that it holds no
    // register across the products
    const int n_valid = a.n_valid_dev != nullptr ? __ldg(a.n_valid_dev) : a.n_valid;
    const int G = min(TCF_CANDS, a.B - b0);
    for (int g = tid; g < G; g += consumers) {
        const int b = b0 + g;
        const int sup = __ldcg(out_s + b) - a.n_pad;
        out_s[b] = sup;
        bool k = b + a.row_off < n_valid;
        if (ICEBERG) k = k && sup >= a.min_sup;
        if (CBO && k) {
            const size_t o = (size_t)b * W;
#pragma unroll
            for (int w = 0; w < W; ++w)
                if (((__ldcg(out_c + o + w) ^ a.parent[o + w]) & a.lowrow[o + w]) != 0u)
                    k = false;  // not canonical
        }
        a.keep[b] = k ? 1 : 0;
    }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Rows per CTA, in 64-row tiles: where (candidate tiles x shards) leave
// the card short of CTAs, the row axis splits.  Picks the split with the
// fewest waves x (tiles of one CTA + 2), 2 tiles standing for a CTA's
// fixed cost (the candidate plane, the ring's fill, the epilogue).
static void row_split(int ctas, int T, int sms, int& tps, int& nsplit)
{
    tps = 1;
    nsplit = 1;
    long best = -1;
    for (int s = 1; s <= T && s <= 1024; ++s) {
        const int t = (T + s - 1) / s, n = (T + t - 1) / t;
        const long cost = (((long)ctas * n + sms - 1) / sms) * (t + 2);
        if (best < 0 || cost < best) {
            best = cost;
            tps = t;
            nsplit = n;
        }
    }
}

template <int W, bool FUSED, bool ICEBERG, bool CBO>
static int launch_tc(TcfArgs a, int K, cudaStream_t stream)
{
    using C = Tcf<W>;
    const auto kernel = closure_tc_kernel<W, FUSED, ICEBERG, CBO>;
    static bool raised = false;
    if (!raised) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
        if (err != cudaSuccess) return (int)err;
        raised = true;
    }
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (a.B + TCF_CANDS - 1) / TCF_CANDS;
    row_split(tiles * K, (a.N + TCF_ROWS - 1) / TCF_ROWS, sms, a.tps, a.nsplit);
    if (K > 65535) return (int)cudaErrorInvalidConfiguration;
    if (a.nsplit > 1) {  // the outputs' identities, then AND / add per split
        err = cudaMemsetAsync(a.out_c, 0xff, (size_t)K * a.B * W * 4, stream);
        if (err == cudaSuccess) err = cudaMemsetAsync(a.out_s, 0, (size_t)K * a.B * 4, stream);
        if (err == cudaSuccess && FUSED)
            err = cudaMemsetAsync(a.arrived, 0, (size_t)tiles * 4, stream);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<dim3(tiles, a.nsplit, K), TCF_THREADS, C::SMEM, stream>>>(a);
    return (int)cudaGetLastError();
}

template <bool FUSED, bool ICEBERG, bool CBO>
static int dispatch_tc(const TcfArgs& a, int W, int K, cudaStream_t stream)
{
    switch (W) {
#define TCF_CASE(w) \
    case w: return launch_tc<w, FUSED, ICEBERG, CBO>(a, K, stream);
        TCF_CASE(1) TCF_CASE(2) TCF_CASE(3) TCF_CASE(4) TCF_CASE(5)
        TCF_CASE(6) TCF_CASE(7) TCF_CASE(8) TCF_CASE(9) TCF_CASE(10)
#undef TCF_CASE
    }
    return (int)cudaErrorInvalidValue;
}

template <bool ICEBERG, bool CBO>
static int launch_fused(const void* rows, const void* cands, const void* mask,
                        const void* parent, const void* lowrow,
                        void* out_c, void* out_s, void* keep, void* arrived,
                        const int* n_valid_dev, int N, int B, int W,
                        int n_valid, int min_sup, int n_pad, int row_off,
                        int* tensor_body, cudaStream_t stream)
{
    *tensor_body = W <= TCF_MAX_W;
    if (*tensor_body) {
        const TcfArgs a = {(const uint32_t*)rows, (const uint32_t*)cands,
                           (const uint32_t*)mask, (const uint32_t*)parent,
                           (const uint32_t*)lowrow, (uint32_t*)out_c, (int*)out_s,
                           (uint8_t*)keep, (int*)arrived, n_valid_dev, N, B, n_valid,
                           min_sup, n_pad, row_off, 1, 1};
        return dispatch_tc<true, ICEBERG, CBO>(a, W, 1, stream);
    }
    const size_t smem = closure_smem_bytes(W);
    cudaError_t err = closure_smem_attr(fused_step_kernel<ICEBERG, CBO>, smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = (B + CLOSURE_GROUP - 1) / CLOSURE_GROUP;
    fused_step_kernel<ICEBERG, CBO><<<grid, CLOSURE_THREADS, smem, stream>>>(
        (const uint32_t*)rows, (const uint32_t*)cands, (const uint32_t*)mask,
        (const uint32_t*)parent, (const uint32_t*)lowrow,
        (uint32_t*)out_c, (int*)out_s, (uint8_t*)keep, n_valid_dev,
        N, B, W, n_valid, min_sup, n_pad, row_off);
    return (int)cudaGetLastError();
}

// The tensor body's candidates per CTA (the length of fused_step's
// `arrived` scratch is ceil(B / this)).
extern "C" int frontier_tc_cands() { return TCF_CANDS; }

// The widest rows, in words, the SIMT body takes on the current device:
// its candidates and accumulators (closure_smem_bytes) in the shared
// memory one block may opt in to.  Returns 0, or the CUDA error of the
// device query.
extern "C" int frontier_simt_max_w(int* max_w)
{
    int dev = 0, smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    *max_w = (int)((smem / sizeof(uint32_t) - 2 * CLOSURE_GROUP) / (2 * CLOSURE_GROUP));
    return 0;
}

// K2.  rows [N, W], cands [B, W], mask [W], parent/lowrow [B, W] (CbO
// only, else null) → out_c [B, W], out_s [B], keep [B] (bool bytes);
// arrived: int32 scratch [ceil(B / TCF_CANDS)] for W <= TCF_MAX_W, else
// unused; n_valid_dev: a device int read in place of n_valid, or null;
// B >= 1.  W <= TCF_MAX_W takes the tensor body, wider W the SIMT
// body; *tensor_body says which (1 or 0).  Launches on `stream` and
// returns cudaGetLastError() (0 on success), or the error that stopped the
// launch.
extern "C" int fused_step_launch(const void* rows, const void* cands,
                                 const void* mask, const void* parent,
                                 const void* lowrow, void* out_c,
                                 void* out_s, void* keep, void* arrived,
                                 const void* n_valid_dev,
                                 int N, int B, int W,
                                 int n_valid, int min_sup, int n_pad,
                                 int row_off, int iceberg, int cbo,
                                 int* tensor_body, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    const int* nv = (const int*)n_valid_dev;
    if (iceberg && cbo)
        return launch_fused<true, true>(rows, cands, mask, parent, lowrow, out_c,
                                        out_s, keep, arrived, nv, N, B, W, n_valid,
                                        min_sup, n_pad, row_off, tensor_body, st);
    if (iceberg)
        return launch_fused<true, false>(rows, cands, mask, parent, lowrow, out_c,
                                         out_s, keep, arrived, nv, N, B, W, n_valid,
                                         min_sup, n_pad, row_off, tensor_body, st);
    if (cbo)
        return launch_fused<false, true>(rows, cands, mask, parent, lowrow, out_c,
                                         out_s, keep, arrived, nv, N, B, W, n_valid,
                                         min_sup, n_pad, row_off, tensor_body, st);
    return launch_fused<false, false>(rows, cands, mask, parent, lowrow, out_c,
                                      out_s, keep, arrived, nv, N, B, W, n_valid,
                                      min_sup, n_pad, row_off, tensor_body, st);
}

// K3.  rows [K, N, W], cands [B, W], mask [W] (null: no mask) → out_c
// [K, B, W], out_s [K, B]; K, B >= 1.  W <= TCF_MAX_W takes the tensor body, wider W the
// SIMT body; *tensor_body says which (1 or 0).  Launches on `stream` and
// returns cudaGetLastError(), or the error that stopped the launch.
extern "C" int map_closure_launch(const void* rows, const void* cands,
                                  const void* mask, void* out_c, void* out_s,
                                  int K, int N, int B, int W, int* tensor_body,
                                  void* stream)
{
    *tensor_body = W <= TCF_MAX_W;
    if (*tensor_body) {
        const TcfArgs a = {(const uint32_t*)rows, (const uint32_t*)cands,
                           (const uint32_t*)mask, nullptr, nullptr, (uint32_t*)out_c,
                           (int*)out_s, nullptr, nullptr, nullptr, N, B, 0, 0, 0, 0, 1, 1};
        return dispatch_tc<false, false, false>(a, W, K, (cudaStream_t)stream);
    }
    const size_t smem = closure_smem_bytes(W);
    cudaError_t err = closure_smem_attr(map_closure_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((B + CLOSURE_GROUP - 1) / CLOSURE_GROUP, K);
    map_closure_kernel<<<grid, CLOSURE_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, (const uint32_t*)cands, (const uint32_t*)mask,
        (uint32_t*)out_c, (int*)out_s, N, B, W);
    return (int)cudaGetLastError();
}

// K1.  rows [K, N, W], cands [B, W] → raw closures out_c [K, B, W] and
// supports out_s [K, B]; K, B >= 1.  K3 without a mask: the same bodies,
// chosen by W alone, *tensor_body saying which.
extern "C" int closure_launch(const void* rows, const void* cands, void* out_c,
                              void* out_s, int K, int N, int B, int W, int* tensor_body,
                              void* stream)
{
    return map_closure_launch(rows, cands, nullptr, out_c, out_s, K, N, B, W, tensor_body,
                              stream);
}

// ---------------------------------------------------------------------------
// K4 — the filter half of a multi-shard round, with the simulated shards'
// fold in its body.
//
// Replaces: src/repro/kernels/frontier.py:filter_call (body
// _filter_kernel, _keep_mask, _row_valid) and, on a simulated plan, the
// AND-allreduce, the support psum and the LOW[gens] gather the reference
// runs in front of it (src/repro/core/engine.py, spmd_step_fused's
// multi-shard body and posts).  From K3's per-shard partials lc [K][B][W]
// and ls [K][B] (K >= 1), per candidate b:
//   gc[b]      = AND over k of lc[k][b]        (K = 1: lc itself, not copied)
//   support[b] = Σ over k of ls[k][b] − n_pad  (where ls is given)
//   keep[b]    = (b + row_off < n_valid)
//                && (!ICEBERG || support[b] >= min_sup)
//                && (!CBO || ((gc[b] ^ parent[b]) & LOW[gens[b]]) == 0)
// A process-group rank calls it at K = 1, on the closures and supports its
// collectives reduced.  On one card nothing crosses a wire, so on a
// simulated plan the AND-allreduce is this fold over the leading axis; AND
// and the int32 sum are exact in any order, so the result is the
// collectives' bit for bit, whatever their schedule.  n_valid, min_sup,
// n_pad and row_off are plain int launch arguments, so nothing is rebuilt
// per threshold or count (n_valid_dev, where given, is read in place of
// n_valid, as in K2); ICEBERG and CBO are template parameters.  A gens entry
// outside [0, n_low) drops its candidate, as the plain version does (the
// frontier never sends one).
//
// What bounds it on the H100: memory.  It reads K*B*(W + 1) words (plus
// B*W parent words, B gens and the LOW rows gathered, for CbO) and writes
// B*W closure words (K > 1), B supports and B keep bytes, with K - 1 ANDs
// per word: at the main path's largest chunk (K = 8, B = 8192, W = 5)
// about 1.7 MB, half a microsecond at 3.35 TB/s, so the launch is latency.
// What the design does about it: every load of a candidate is issued at
// once, across lanes, not as one thread's dependent chain.  A segment of
// L = min(32, next power of two >= W) lanes owns one candidate (32 / L
// candidates a warp, the grid covering B*L threads: 128 CTAs at B = 8192,
// W = 4); lane j takes words j, j + L, ... and folds their K partials in
// registers (four loads in flight at a time), and the K supports j, j + L,
// ... which a shuffle sum over the segment adds up.  Every lane then knows
// the validity and iceberg tests; only candidates they keep read parent and
// their LOW row, and the CbO test is a ballot over the segment's lanes.
// ---------------------------------------------------------------------------

#define FILTER_THREADS 256

template <bool ICEBERG, bool CBO>
__global__ void __launch_bounds__(FILTER_THREADS)
filter_kernel(const uint32_t* __restrict__ lc,
              const int* __restrict__ ls,
              const uint32_t* __restrict__ parent,
              const uint32_t* __restrict__ low,
              const int* __restrict__ gens,
              uint32_t* __restrict__ gc,
              int* __restrict__ out_s,
              uint8_t* __restrict__ keep,
              const int* __restrict__ n_valid_dev,
              int K, int B, int W, int L, int n_low,
              int n_valid, int min_sup, int n_pad, int row_off)
{
    if (n_valid_dev != nullptr) n_valid = __ldg(n_valid_dev);
    // no early exit: every lane reaches the segment's shuffles and ballot
    const int lane = threadIdx.x & 31, j = lane & (L - 1);
    const long b = ((long)blockIdx.x * FILTER_THREADS + threadIdx.x) / L;
    const bool in = b < B;
    const size_t plane = (size_t)B * W;  // one shard's partial closures

    int sup = 0;
    if (ls != nullptr) {
        if (in)
            for (int k = j; k < K; k += L) sup += __ldg(ls + (size_t)k * B + b);
        for (int off = L >> 1; off > 0; off >>= 1)
            sup += __shfl_xor_sync(FULL_WORD, sup, off);
        sup -= n_pad;
    }
    bool kept = in && b + row_off < n_valid;
    if (ICEBERG) kept = kept && sup >= min_sup;

    const uint32_t* lowrow = nullptr;
    if (CBO && kept) {
        const int g = __ldg(gens + b);
        if (g >= 0 && g < n_low) lowrow = low + (size_t)g * W;
        else kept = false;
    }
    bool bad = false;
    if (in && (K > 1 || (CBO && kept))) {
        for (int w = j; w < W; w += L) {
            const uint32_t* p = lc + (size_t)b * W + w;
            uint32_t x = __ldg(p);
            int s = 1;
            for (; s + 4 <= K; s += 4)
                x &= __ldg(p + s * plane) & __ldg(p + (s + 1) * plane) &
                     __ldg(p + (s + 2) * plane) & __ldg(p + (s + 3) * plane);
            for (; s < K; ++s) x &= __ldg(p + s * plane);
            if (K > 1) gc[(size_t)b * W + w] = x;
            if (CBO && kept && ((x ^ __ldg(parent + (size_t)b * W + w)) & __ldg(lowrow + w)) != 0u)
                bad = true;  // not canonical
        }
    }
    if (CBO) {
        const unsigned seg = L == 32 ? FULL_WORD : ((1u << L) - 1u) << (lane & ~(L - 1));
        if (__ballot_sync(FULL_WORD, bad) & seg) kept = false;
    }
    if (in && j == 0) {
        if (ls != nullptr) out_s[b] = sup;
        keep[b] = kept ? 1 : 0;
    }
}

template <bool ICEBERG, bool CBO>
static int launch_filter(const void* lc, const void* ls, const void* parent, const void* low,
                         const void* gens, void* gc, void* out_s, void* keep,
                         const int* n_valid_dev, int K, int B, int W, int n_low,
                         int n_valid, int min_sup, int n_pad, int row_off,
                         cudaStream_t stream)
{
    int L = 1;
    while (L < W && L < 32) L <<= 1;
    const long threads = (long)B * L;
    const long grid = (threads + FILTER_THREADS - 1) / FILTER_THREADS;
    if (grid > 0x7fffffffL) return (int)cudaErrorInvalidConfiguration;
    filter_kernel<ICEBERG, CBO><<<(unsigned)grid, FILTER_THREADS, 0, stream>>>(
        (const uint32_t*)lc, (const int*)ls, (const uint32_t*)parent, (const uint32_t*)low,
        (const int*)gens, (uint32_t*)gc, (int*)out_s, (uint8_t*)keep, n_valid_dev,
        K, B, W, L, n_low, n_valid, min_sup, n_pad, row_off);
    return (int)cudaGetLastError();
}

// K4.  lc [K, B, W] and ls [K, B] (null: no supports; iceberg needs them)
// → gc [B, W] (K > 1 only; at K = 1 the closures are lc), out_s [B] (with
// ls) and keep [B] (bool bytes); CbO also reads parent [B, W], gens [B]
// and LOW [n_low, W]; n_valid_dev: a device int read in place of n_valid,
// or null.  K, B, W >= 1.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for operands
// the variant needs and did not get.
extern "C" int filter_launch(const void* lc, const void* ls, const void* parent,
                             const void* low, const void* gens, void* gc, void* out_s,
                             void* keep, const void* n_valid_dev, int K, int B, int W,
                             int n_low,
                             int n_valid, int min_sup, int n_pad, int row_off,
                             int iceberg, int cbo, void* stream)
{
    if (K < 1 || B < 1 || W < 1 || (K > 1 && gc == nullptr) ||
        (ls == nullptr) != (out_s == nullptr) || (iceberg && ls == nullptr) ||
        (cbo && (parent == nullptr || low == nullptr || gens == nullptr || n_low < 1)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define FILTER_CASE(I, C)                                                                  \
    return launch_filter<I, C>(lc, ls, parent, low, gens, gc, out_s, keep,                \
                               (const int*)n_valid_dev, K, B, W, n_low, n_valid, min_sup, \
                               n_pad, row_off, st)
    if (iceberg && cbo) FILTER_CASE(true, true);
    if (iceberg) FILTER_CASE(true, false);
    if (cbo) FILTER_CASE(false, true);
    FILTER_CASE(false, false);
#undef FILTER_CASE
}
