// K7 — flash attention, forward, hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (body
// _flash_kernel), and serves the reference's model-layout scan
// src/repro/models/attention.py:blockwise_attention on the prefill path.
// For each batch row b, query head h (KV head h / G: no repeated K/V) and
// query row i < S, at position p = q_off + i among the T keys:
//   s_ij = softcap(q_i . k_j * scale),  softcap(x) = cap * tanh(x / cap)
//   key j valid iff  j < T  and  j >= valid_from[b]
//                    and (causal => j <= p)  and (window >= 0 => p - j < window)
//   o_i  = sum_j p_ij v_j / sum_j p_ij over valid j, by an online softmax
//          over key tiles with a float32 running max and sum (-2^30 for
//          "no key yet", as in the reference);
//   p_ij is rounded to V's type before P.V and the running sum adds the
//   rounded p (blockwise_attention's rounding; a no-op in float32);
//   a query row with no valid key (a left pad) is written as 0.
// Tiles of keys wholly above the diagonal, wholly outside the window or
// wholly before valid_from are never read (the key range of a query tile is
// cut before the loop, as pl.when(run) skips blocks).  causal, window,
// the query offset q_off (0 for a whole sequence; r * S for the rows one
// rank of a sequence-sharded attention owns), logit cap, valid_from, S, T,
// the strides and the scale are launch arguments: none forces a rebuild.  The head dim hd (a multiple of 8 up
// to 256) is rounded up to one of five compile-time widths (16 ... 256);
// element types float32 and bfloat16.  Strides let one kernel read the
// [B, H, S, hd] layout of flash_attention and the [B, S, H, hd] layout of
// the model.
//
// What bounds it on the H100: the two matrix products, 4 * hd operations
// per valid (query, key) pair, against 989 TFLOP/s of bf16 tensor cores;
// q, k, v and o cross device memory once each (3.35 TB/s), far less at
// any prefill length that matters.  Beside the products, every score
// takes a scale, a max, an exp2 and, with the gemma2 cap, an exact tanhf
// on the FMA pipes (about 33 T instructions/s): at hd 256 that is of the
// same order as the products' time, so the softmax of one warpgroup has
// to overlap the products of another.
//
// What the design does about it, by element type:
//   bfloat16 (the model's prefill) — flash_fwd_wgmma_kernel below: one
//   CTA per (b, KV head, query tile), warp-specialised.  One thread of a
//   producer warpgroup keeps a ring of K/V stages in flight through TMA
//   (mbarriers, 128-byte swizzle, out-of-bounds rows and columns
//   zero-filled by the copy) and Q on its own barrier; two
//   consumer warpgroups each own 64 query rows and run Q.K^T and P.V
//   through wgmma from shared memory, P from registers.  Where G >= 2 the
//   two warpgroups take two query heads of one KV head at the same rows,
//   so each K/V tile in shared memory serves both; only tiles that cross
//   the diagonal, the window edge, valid_from or T get the per-element
//   mask; query tiles are issued heaviest first.
//   float32 (the reduced configs and the parity cases) — the exact
//   version on the FMA pipes (flash_fwd_kernel): one CTA of 256 threads per
//   (b, h, 64-query tile), K and V tiles of 32 keys staged in shared memory
//   as float32 (rows padded to an odd stride, so the 32 lanes of a warp hit
//   distinct banks), four threads per query row, P in shared memory between
//   the products; bound by shared-memory loads, about one per FMA.
#include <climits>
#include <type_traits>

#include <cuda_bf16.h>

#include "hopper.cuh"

#define FA_BQ 64
#define FA_BK 32
#define FA_THREADS 256
#define FA_NEG_INF (-1073741824.0f)  // -2^30, the reference's NEG_INF
#define FULL_MASK 0xffffffffu

// ---------------------------------------------------------------------------
// float32: the exact version on the FMA pipes
// ---------------------------------------------------------------------------

static size_t smem_bytes(int hd)
{
    const int ld = hd + 1;
    return sizeof(float) *
           ((size_t)FA_BQ * ld + (size_t)FA_BK * ld + (size_t)FA_BK * hd +
            (size_t)FA_BQ * (FA_BK + 1));
}

template <int HDMAX>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ valid_from, int G,
                 int S, int T_, int hd,
                 long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kst,
                 long long vsb, long long vsh, long long vst,
                 long long osb, long long osh, long long oss,
                 int causal, int window, int q_off, float cap, float scale)
{
    extern __shared__ float smem[];
    const int ld = hd + 1;
    float* qs = smem;             // [FA_BQ][ld]
    float* ks = qs + FA_BQ * ld;  // [FA_BK][ld]
    float* vs = ks + FA_BK * ld;  // [FA_BK][hd]
    float* ps = vs + FA_BK * hd;  // [FA_BQ][FA_BK + 1]

    const int tid = threadIdx.x;
    const int h = blockIdx.y, b = blockIdx.z;
    const int q0 = blockIdx.x * FA_BQ;
    const int vf = valid_from != nullptr ? max(valid_from[b], 0) : 0;
    const float* qb = q + b * qsb + h * qsh;
    const float* kb = k + b * ksb + (h / G) * ksh;
    const float* vb = v + b * vsb + (h / G) * vsh;
    float* ob = o + b * osb + h * osh;

    // four threads per query row: row r, score columns sub + 4c, output
    // columns sub + 4jj
    const int r = tid >> 2, sub = tid & 3;
    const int i = q0 + r, ip = q_off + i;  // the row and its position

    for (int idx = tid; idx < FA_BQ * hd; idx += FA_THREADS) {
        const int rr = idx / hd, d = idx - rr * hd;
        qs[rr * ld + d] = q0 + rr < S ? qb[(q0 + rr) * qss + d] : 0.f;
    }

    // the keys any row of this tile may see: [k_lo, k_hi)
    const int q_last = min(q0 + FA_BQ, S) - 1;
    int k_lo = vf, k_hi = T_;
    if (causal) k_hi = min(k_hi, q_off + q_last + 1);
    if (window >= 0) k_lo = max(k_lo, q_off + q0 - window + 1);

    float m = FA_NEG_INF, l = 0.f;
    float acc[HDMAX / 4];
#pragma unroll
    for (int jj = 0; jj < HDMAX / 4; ++jj) acc[jj] = 0.f;

    for (int k0 = (k_lo / FA_BK) * FA_BK; k0 < k_hi; k0 += FA_BK) {
        __syncthreads();  // the previous tile's readers are done
        for (int idx = tid; idx < FA_BK * hd; idx += FA_THREADS) {
            const int c = idx / hd, d = idx - c * hd;
            const int j = k0 + c;
            const bool in = j < T_;
            ks[c * ld + d] = in ? kb[j * kst + d] : 0.f;
            vs[c * hd + d] = in ? vb[j * vst + d] : 0.f;
        }
        __syncthreads();

        float sc[FA_BK / 4];
#pragma unroll
        for (int c = 0; c < FA_BK / 4; ++c) sc[c] = 0.f;
        const float* qrow = qs + r * ld;
        for (int d = 0; d < hd; ++d) {
            const float qd = qrow[d];
#pragma unroll
            for (int c = 0; c < FA_BK / 4; ++c)
                sc[c] = fmaf(qd, ks[(sub + 4 * c) * ld + d], sc[c]);
        }
        float mloc = FA_NEG_INF;
        uint32_t valid = 0u;
#pragma unroll
        for (int c = 0; c < FA_BK / 4; ++c) {
            const int j = k0 + sub + 4 * c;
            bool ok = i < S && j < T_ && j >= vf;
            if (causal) ok = ok && j <= ip;
            if (window >= 0) ok = ok && ip - j < window;
            float s = sc[c] * scale;
            if (cap > 0.f) s = cap * tanhf(s / cap);
            sc[c] = s;
            if (ok) {
                valid |= 1u << c;
                mloc = fmaxf(mloc, s);
            }
        }
        mloc = fmaxf(mloc, __shfl_xor_sync(FULL_MASK, mloc, 1));
        mloc = fmaxf(mloc, __shfl_xor_sync(FULL_MASK, mloc, 2));
        const float m_new = fmaxf(m, mloc);
        const float alpha = expf(m - m_new);
        float lsum = 0.f;
        float* prow = ps + r * (FA_BK + 1);
#pragma unroll
        for (int c = 0; c < FA_BK / 4; ++c) {
            const float p = (valid >> c) & 1u ? expf(sc[c] - m_new) : 0.f;
            lsum += p;
            prow[sub + 4 * c] = p;
        }
        lsum += __shfl_xor_sync(FULL_MASK, lsum, 1);
        lsum += __shfl_xor_sync(FULL_MASK, lsum, 2);
        l = l * alpha + lsum;
        m = m_new;
        __syncwarp();  // the row's four threads wrote their p (one warp holds 8 rows)

#pragma unroll
        for (int jj = 0; jj < HDMAX / 4; ++jj) acc[jj] *= alpha;
        for (int c = 0; c < FA_BK; ++c) {
            const float p = prow[c];
            const float* vrow = vs + c * hd + sub;
#pragma unroll
            for (int jj = 0; jj < HDMAX / 4; ++jj)
                if (4 * jj + sub < hd) acc[jj] = fmaf(p, vrow[4 * jj], acc[jj]);
        }
    }

    if (i >= S) return;
    if (lse != nullptr && sub == 0)
        lse[((long long)b * gridDim.y + h) * S + i] = l > 0.f ? m + logf(l) : INFINITY;
    float* orow = ob + i * oss;
#pragma unroll
    for (int jj = 0; jj < HDMAX / 4; ++jj) {
        const int d = 4 * jj + sub;
        if (d < hd) orow[d] = l > 0.f ? acc[jj] / fmaxf(l, 1e-37f) : 0.f;
    }
}

// ---------------------------------------------------------------------------
// bfloat16: warp-specialised wgmma behind a TMA ring
//
// CTA = 3 warpgroups (384 threads): warpgroups 0 and 1 consume, each owning
// 64 query rows; warpgroup 2 produces (one of its threads issues every
// copy; it hands its registers to the consumers with setmaxnreg).
//   G >= 2: the CTA serves query heads 2p and 2p + 1 of KV head kvh (blockIdx.x
//     = kvh * ceil(G / 2) + p) at the same 64 rows; for odd G the second
//     warpgroup of the last pair has no head and leaves at once.
//   G == 1: the two warpgroups take two consecutive 64-row tiles of one head;
//     the producer loads the union of their key tiles and each warpgroup
//     skips the tiles outside its own range.
// blockIdx.z walks the query tiles from the last (most keys under causal
// masking) to the first, so the longest rows start first.
//
// Shared memory (1024-byte aligned): Q [2][64 x HDP], then STAGES stages of
// K [64 x HDP] and V [64 x HDP], then the mbarriers.  Each 64-row tile is
// HDP / 64 boxes of 64 rows x 64 columns (128-byte rows, 128-byte swizzle:
// a box is the swizzle atom wgmma reads); below 64 columns one box of
// 32- or 64-byte rows with the matching swizzle.  TMA writes the boxes and
// fills rows past S or T and columns past hd (up to HDP) with 0.
//
// Per key tile a consumer warpgroup: waits for the stage; S = Q.K^T by
// HDP / 16 wgmma m64n64k16 (both operands K-major in shared memory);
// scale (and cap) in the exp2 domain, the mask on boundary tiles only, the
// online softmax over the fragment's rows (each row lives in 4 lanes); the
// rounded p repacked in registers as the A operand (the accumulator layout
// of two 8-key blocks is the A layout of one 16-key step); O += P.V by 4
// wgmma m64n{HDP}k16 with V read MN-major from shared memory; then its
// four warps release the stage.  The two warpgroups run independently, so
// one's softmax overlaps the other's products and the producer's copies.
// ---------------------------------------------------------------------------

#define TC_BQ 64        // query rows of one consumer warpgroup
#define TC_BK 64        // keys of one stage
#define TC_THREADS 384  // two consumer warpgroups and one producer warpgroup
#define TC_LOG2E 1.4426950408889634f

template <int HDP> struct Tc {
    static constexpr int BOXC = HDP < 64 ? HDP : 64;  // columns of one box
    static constexpr int RB = 2 * BOXC;               // bytes of a shared-memory row
    static constexpr int NBOX = HDP / BOXC;
    static constexpr int BOX = TC_BK * RB;            // bytes of one box of 64 rows
    static constexpr int TILE = NBOX * BOX;           // bytes of one 64-row tile
    static constexpr int KPR = RB / 32;               // k16 steps within one row
    static constexpr int STAGES = HDP == 256 ? 2 : 4;
    static constexpr int LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;  // wgmma swizzle code
    static constexpr CUtensorMapSwizzle SWIZZLE =
        RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                  : RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
    // the alignment slack, Q, the stages, full[STAGES] empty[STAGES] qfull[2]:
    // 197,680 bytes at HDP 256 (two stages), 164,944 at 128 (four), under
    // the 227 KB one CTA may take
    static constexpr size_t SMEM = 1024 + (size_t)(2 + 2 * STAGES) * TILE + 8 * (2 * STAGES + 2);
};

// The products.  PTX names every accumulator register of a wgmma, so the
// operand lists are written out: wgmma_ss is S (+)= Q.K^T, m64n64k16, both
// operands K-major in shared memory; wgmma_rs is O += P.V, m64n{N}k16, P
// from registers, V MN-major (transposed) in shared memory.
#define WG_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F8(d, i) WG_F4(d, i), WG_F4(d, i + 4)
#define WG_F16(d, i) WG_F8(d, i), WG_F8(d, i + 8)
#define WG_F32(d, i) WG_F16(d, i), WG_F16(d, i + 16)
#define WG_F64(d, i) WG_F32(d, i), WG_F32(d, i + 32)
#define WG_F128(d, i) WG_F64(d, i), WG_F64(d, i + 64)

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_F32(d, 0)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        " {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : WG_F8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : WG_F16(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_F32(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_F64(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127},"
        " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : WG_F128(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// the key tiles of BK keys [lo, hi) that rows [qa, qa + 64) of a query tile
// (at positions q_off + qa ...) may see
template <int BK = TC_BK>
__device__ __forceinline__ void key_tiles(int qa, int S, int T_, int vf, int causal, int window,
                                          int q_off, int& lo, int& hi)
{
    int k_lo = vf, k_hi = T_;
    if (causal) k_hi = min(k_hi, q_off + min(qa + TC_BQ, S));
    if (window >= 0) k_lo = max(k_lo, q_off + qa - window + 1);
    lo = k_lo < k_hi ? k_lo / BK : 0;
    hi = k_lo < k_hi ? (k_hi + BK - 1) / BK : 0;
}

// One key tile of one consumer warpgroup: this thread's rows sit at
// positions i0 and i0 + 8, its columns of each 8-column block cq and cq + 1.  MASK: the tile
// crosses the diagonal, the window edge, valid_from or T, so each score is
// masked on its own; interior tiles skip it.  Scores are kept in the exp2
// domain: x * log2(e), with the cap applied first (exact tanhf).
template <int HDP, bool MASK>
__device__ __forceinline__ void tc_tile(float (&O)[HDP / 2], float& m0, float& m1, float& l0,
                                        float& l1, uint64_t qdesc, uint64_t kdesc,
                                        uint64_t vdesc, int j0, int i0, int cq, int T_, int vf,
                                        int causal, int window, float cap_l2, float sc)
{
    using C = Tc<HDP>;
    float s[32];
#pragma unroll
    for (int n = 0; n < 32; ++n) s[n] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t off = (kk / C::KPR) * C::BOX + (kk % C::KPR) * 32;
        wgmma_ss(s, qdesc + (off >> 4), kdesc + (off >> 4), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    if (cap_l2 > 0.f) {
#pragma unroll
        for (int n = 0; n < 32; ++n) s[n] = cap_l2 * tanhf(s[n] * sc);
    } else {
#pragma unroll
        for (int n = 0; n < 32; ++n) s[n] *= sc;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float x = s[4 * n + e];
            if (MASK) {
                const int i = e < 2 ? i0 : i0 + 8;
                const int j = j0 + 8 * n + cq + (e & 1);
                bool ok = j < T_ && j >= vf;
                if (causal) ok = ok && j <= i;
                if (window >= 0) ok = ok && i - j < window;
                x = ok ? x : -__int_as_float(0x7f800000);  // -inf: p = 0, max unchanged
                s[4 * n + e] = x;
            }
            if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_MASK, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_MASK, mx1, off));
    }
    const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // p rounded to bf16, packed as the A operand: pa[2n] row i0, pa[2n + 1]
    // row i0 + 8, of the 8-key block n; the sum adds the rounded p
    uint32_t pa[16];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        const __nv_bfloat162 p01 =
            __floats2bfloat162_rn(exp2f(s[4 * n] - mx0), exp2f(s[4 * n + 1] - mx0));
        const __nv_bfloat162 p23 =
            __floats2bfloat162_rn(exp2f(s[4 * n + 2] - mx1), exp2f(s[4 * n + 3] - mx1));
        const float2 f01 = __bfloat1622float2(p01), f23 = __bfloat1622float2(p23);
        ps0 += f01.x + f01.y;
        ps1 += f23.x + f23.y;
        pa[2 * n] = *reinterpret_cast<const uint32_t*>(&p01);
        pa[2 * n + 1] = *reinterpret_cast<const uint32_t*>(&p23);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
        O[4 * n] *= al0;
        O[4 * n + 1] *= al0;
        O[4 * n + 2] *= al1;
        O[4 * n + 3] *= al1;
    }
    fence_regs(O);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        wgmma_rs(O, a, vdesc + ((uint32_t)(kk * 16 * C::RB) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(O);
}

template <int HDP>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, const int* __restrict__ valid_from, int G,
                       int H, int S, int T_, int hd,
                       long long osb, long long osh, long long oss, int causal, int window,
                       int q_off, float cap, float scale)
{
    using C = Tc<HDP>;
    extern __shared__ unsigned char tc_smem[];
    const uint32_t q_sm = (smem_u32(tc_smem) + 1023u) & ~1023u;  // [2][TILE]
    const uint32_t k_sm = q_sm + 2 * C::TILE;                     // [STAGES][TILE]
    const uint32_t v_sm = k_sm + C::STAGES * C::TILE;             // [STAGES][TILE]
    const uint32_t full = v_sm + C::STAGES * C::TILE;             // + 8 s
    const uint32_t empty = full + 8 * C::STAGES;                  // + 8 s
    const uint32_t qfull = empty + 8 * C::STAGES;                 // + 8 w

    const int NP = G == 1 ? 1 : (G + 1) / 2;
    const int kvh = blockIdx.x / NP, pair = blockIdx.x - kvh * NP, b = blockIdx.y;
    const int qt = gridDim.z - 1 - blockIdx.z;
    const int vf = valid_from != nullptr ? max(valid_from[b], 0) : 0;
    // the two consumer warpgroups: head, first row, activity, key tiles
    const int head0 = G == 1 ? kvh : kvh * G + 2 * pair, head1 = G == 1 ? kvh : head0 + 1;
    const int qa0 = G == 1 ? qt * 2 * TC_BQ : qt * TC_BQ, qa1 = G == 1 ? qa0 + TC_BQ : qa0;
    const bool act0 = qa0 < S, act1 = (G == 1 || 2 * pair + 1 < G) && qa1 < S;
    int lo0, hi0, lo1, hi1;
    key_tiles(qa0, S, T_, vf, causal, window, q_off, lo0, hi0);
    key_tiles(qa1, S, T_, vf, causal, window, q_off, lo1, hi1);
    if (!act1) lo1 = hi1 = 0;
    // the union the producer loads (contiguous: the ranges overlap or meet)
    int u_lo = INT_MAX, u_hi = 0;
    if (lo0 < hi0) u_lo = lo0, u_hi = hi0;
    if (lo1 < hi1) u_lo = min(u_lo, lo1), u_hi = max(u_hi, hi1);
    if (u_lo >= u_hi) u_lo = u_hi = 0;

    const int tid = threadIdx.x;
    if (tid == 0) {
#pragma unroll
        for (int s = 0; s < C::STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, 4 * (act0 + act1));  // each consumer warp releases
        }
        mbar_init(qfull, 1);
        mbar_init(qfull + 8, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= 2 * 128) {
        // producer warpgroup: one thread issues every copy
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (tid == 2 * 128) {
            if (lo0 < hi0) {
                mbar_expect_tx(qfull, C::TILE);
#pragma unroll
                for (int c = 0; c < C::NBOX; ++c)
                    tma_load(q_sm + c * C::BOX, &qmap, qfull, c * C::BOXC, qa0, head0, b);
            }
            if (lo1 < hi1) {
                mbar_expect_tx(qfull + 8, C::TILE);
#pragma unroll
                for (int c = 0; c < C::NBOX; ++c)
                    tma_load(q_sm + C::TILE + c * C::BOX, &qmap, qfull + 8, c * C::BOXC, qa1,
                             head1, b);
            }
            for (int t = u_lo; t < u_hi; ++t) {
                const int i = t - u_lo, s = i % C::STAGES;
                if (i >= C::STAGES) mbar_wait(empty + 8 * s, (i / C::STAGES - 1) & 1);
                const uint32_t bar = full + 8 * s;
                mbar_expect_tx(bar, 2 * C::TILE);
#pragma unroll
                for (int c = 0; c < C::NBOX; ++c) {
                    tma_load(k_sm + s * C::TILE + c * C::BOX, &kmap, bar, c * C::BOXC, t * TC_BK,
                             kvh, b);
                    tma_load(v_sm + s * C::TILE + c * C::BOX, &vmap, bar, c * C::BOXC, t * TC_BK,
                             kvh, b);
                }
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
        const int wg = tid >> 7;
        if (!(wg == 0 ? act0 : act1)) return;  // odd G: no head for this warpgroup
        const int head = wg == 0 ? head0 : head1, qa = wg == 0 ? qa0 : qa1;
        const int my_lo = wg == 0 ? lo0 : lo1, my_hi = wg == 0 ? hi0 : hi1;
        const int warp = (tid & 127) >> 5, lane = tid & 31;
        const int i0 = qa + warp * 16 + (lane >> 2);  // rows i0 and i0 + 8
        const int cq = 2 * (lane & 3);               // columns cq, cq + 1 of each 8
        const float cap_l2 = cap > 0.f ? cap * TC_LOG2E : 0.f;
        const float sc = cap > 0.f ? scale / cap : scale * TC_LOG2E;
        const uint64_t qdesc = smem_desc<C::LAYOUT>(q_sm + wg * C::TILE, 16, 8 * C::RB);

        float O[HDP / 2];
#pragma unroll
        for (int n = 0; n < HDP / 2; ++n) O[n] = 0.f;
        float m0 = FA_NEG_INF, m1 = FA_NEG_INF, l0 = 0.f, l1 = 0.f;
        if (my_lo < my_hi) mbar_wait(qfull + 8 * wg, 0);

        for (int t = u_lo; t < u_hi; ++t) {
            const int i = t - u_lo, s = i % C::STAGES;
            mbar_wait(full + 8 * s, (i / C::STAGES) & 1);
            if (t >= my_lo && t < my_hi) {
                const int j0 = t * TC_BK;
                const uint64_t kdesc = smem_desc<C::LAYOUT>(k_sm + s * C::TILE, 16, 8 * C::RB);
                // V: the next 64 columns one box on (LBO), the next 8 keys 8 rows on (SBO)
                const uint64_t vdesc =
                    smem_desc<C::LAYOUT>(v_sm + s * C::TILE, C::BOX, 8 * C::RB);
                const int pa = q_off + qa;  // the tile's first position
                const bool inner = j0 + TC_BK <= T_ && j0 >= vf &&
                                   (!causal || j0 + TC_BK - 1 <= pa) &&
                                   (window < 0 || pa + TC_BQ - 1 - j0 < window);
                if (inner)
                    tc_tile<HDP, false>(O, m0, m1, l0, l1, qdesc, kdesc, vdesc, j0, q_off + i0,
                                        cq, T_, vf, causal, window, cap_l2, sc);
                else
                    tc_tile<HDP, true>(O, m0, m1, l0, l1, qdesc, kdesc, vdesc, j0, q_off + i0,
                                       cq, T_, vf, causal, window, cap_l2, sc);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + 8 * s);
        }

#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
            l0 += __shfl_xor_sync(FULL_MASK, l0, off);
            l1 += __shfl_xor_sync(FULL_MASK, l1, off);
        }
        __nv_bfloat16* ob = o + b * osb + head * osh;
        const int i1 = i0 + 8;
        if (lse != nullptr && (lane & 3) == 0) {
            // m is in the exp2 domain: lse = (m + log2 l) ln 2
            float* lrow = lse + ((long long)b * H + head) * S;
            if (i0 < S) lrow[i0] = l0 > 0.f ? (m0 + log2f(l0)) * 0.6931471805599453f : INFINITY;
            if (i1 < S) lrow[i1] = l1 > 0.f ? (m1 + log2f(l1)) * 0.6931471805599453f : INFINITY;
        }
#pragma unroll
        for (int n = 0; n < HDP / 8; ++n) {
            const int d = n * 8 + cq;
            if (d >= hd) break;
            if (i0 < S) {
                const float r0 = l0 > 0.f ? O[4 * n] / fmaxf(l0, 1e-37f) : 0.f;
                const float r1 = l0 > 0.f ? O[4 * n + 1] / fmaxf(l0, 1e-37f) : 0.f;
                *reinterpret_cast<__nv_bfloat162*>(ob + i0 * oss + d) = __floats2bfloat162_rn(r0, r1);
            }
            if (i1 < S) {
                const float r0 = l1 > 0.f ? O[4 * n + 2] / fmaxf(l1, 1e-37f) : 0.f;
                const float r1 = l1 > 0.f ? O[4 * n + 3] / fmaxf(l1, 1e-37f) : 0.f;
                *reinterpret_cast<__nv_bfloat162*>(ob + i1 * oss + d) = __floats2bfloat162_rn(r0, r1);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int HDP>
static int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                      const void* valid_from, int B, int H, int KV, int S, int T_, int hd,
                      const long long* st, int causal, int window, int q_off, float cap,
                      float scale, cudaStream_t stream)
{
    const auto kernel = flash_fwd_kernel<HDP>;
    // per instantiation: raise the limit once, to the widest launch (hd = HDP)
    static bool raised = false;
    if (smem_bytes(hd) > 48 * 1024 && !raised) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(HDP));
        if (err != cudaSuccess) return (int)err;
        raised = true;
    }
    const dim3 grid((S + FA_BQ - 1) / FA_BQ, H, B);
    kernel<<<grid, FA_THREADS, smem_bytes(hd), stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, lse,
        (const int*)valid_from, H / KV, S, T_, hd, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
        st[10], st[11], causal, window, q_off, cap, scale);
    return (int)cudaGetLastError();
}

// The 4-D map (hd, rows, heads, B) of a bf16 tensor [B][heads][rows][hd]
// with element strides (sb, sh, sr) and a contiguous hd axis; boxes of
// Tc<HDP>::BOXC columns by box_rows rows.  Returns 0, or an error code to raise.
template <int HDP>
static int tile_map(CUtensorMap* map, const void* ptr, int B, int heads, int rows, int hd,
                    long long sb, long long sh, long long sr, int box_rows = TC_BK)
{
    using C = Tc<HDP>;
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)rows, (cuuint64_t)heads,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)sr * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {(cuuint32_t)C::BOXC, (cuuint32_t)box_rows, 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              C::SWIZZLE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HDP>
static int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                       const void* valid_from, int B, int H, int KV, int S, int T_, int hd,
                       const long long* st, int causal, int window, int q_off, float cap,
                       float scale, cudaStream_t stream)
{
    using C = Tc<HDP>;
    const auto kernel = flash_fwd_wgmma_kernel<HDP>;
    static bool raised = false;
    if (!raised) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
        if (err != cudaSuccess) return (int)err;
        raised = true;
    }
    const int G = H / KV;
    const int rows = G == 1 ? 2 * TC_BQ : TC_BQ;  // query rows of one CTA
    const dim3 grid(KV * (G == 1 ? 1 : (G + 1) / 2), B, (S + rows - 1) / rows);
    if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
    CUtensorMap qm, km, vm;
    int rc = tile_map<HDP>(&qm, q, B, H, S, hd, st[0], st[1], st[2]);
    if (rc == 0) rc = tile_map<HDP>(&km, k, B, KV, T_ > 0 ? T_ : 1, hd, st[3], st[4], st[5]);
    if (rc == 0) rc = tile_map<HDP>(&vm, v, B, KV, T_ > 0 ? T_ : 1, hd, st[6], st[7], st[8]);
    if (rc != 0) return rc;
    kernel<<<grid, TC_THREADS, C::SMEM, stream>>>(qm, km, vm, (__nv_bfloat16*)o, lse,
                                                  (const int*)valid_from, G, H, S, T_, hd, st[9],
                                                  st[10], st[11], causal, window, q_off, cap,
                                                  scale);
    return (int)cudaGetLastError();
}

// hd rounded up to one of the five compiled widths
template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
                    const void* valid_from, int B, int H, int KV, int S, int T_, int hd,
                    const long long* st, int causal, int window, int q_off, float cap,
                    float scale, cudaStream_t stream)
{
#define FA_CASE(W)                                                                          \
    if (hd <= W) {                                                                          \
        if constexpr (std::is_same<T, float>::value)                                        \
            return launch_f32<W>(q, k, v, o, lse, valid_from, B, H, KV, S, T_, hd, st, causal,   \
                                 window, q_off, cap, scale, stream);                        \
        else                                                                                \
            return launch_bf16<W>(q, k, v, o, lse, valid_from, B, H, KV, S, T_, hd, st, causal,  \
                                  window, q_off, cap, scale, stream);                       \
    }
    FA_CASE(16) FA_CASE(32) FA_CASE(64) FA_CASE(128) FA_CASE(256)
#undef FA_CASE
    return (int)cudaErrorInvalidValue;
}

// q [B, H, S, hd] and o by strides (qsb, qsh, qss) / (osb, osh, oss); k, v
// [B, KV, T, hd] by strides (ksb, ksh, kst) / (vsb, vsh, vst); the hd axis
// is contiguous.  dtype 0 = float32, 1 = bfloat16 (all four tensors).
// lse [B, H, S] float32 or null: each row's log-sum-exp of its valid
// scores, m + log(l) in the natural domain over the sums the kernel kept
// (+inf on a row with no valid key), for the backward (K7b); serving
// passes null.  valid_from [B] int32 or null (all 0); window < 0 = none; cap <= 0 =
// none; q_off >= 0 the position of query row 0 among the keys (0 for a whole
// sequence or a cross-attention).
// S >= 1, H % KV == 0, hd a multiple of 8 in [8, 256]; for
// bfloat16, TMA reads q, k and v: 16-byte aligned bases and strides in
// multiples of 8 elements.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or the error that stopped the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, const void* valid_from, int dtype, int B, int H,
                                      int KV, int S, int T, int hd,
                                      long long qsb, long long qsh, long long qss,
                                      long long ksb, long long ksh, long long kst,
                                      long long vsb, long long vsh, long long vst,
                                      long long osb, long long osh, long long oss,
                                      int causal, int window, int q_off, float cap,
                                      float scale, void* stream)
{
    if (B < 1 || S < 1 || T < 0 || KV < 1 || H % KV || hd < 8 || hd > 256 || hd % 8 ||
        q_off < 0)
        return (int)cudaErrorInvalidValue;
    const long long st[12] = {qsb, qsh, qss, ksb, ksh, kst, vsb, vsh, vst, osb, osh, oss};
    if (dtype == 0)
        return dispatch<float>(q, k, v, o, (float*)lse, valid_from, B, H, KV, S, T, hd, st, causal,
                               window, q_off, cap, scale, (cudaStream_t)stream);
    if (dtype == 1) {
        for (int i = 0; i < 12; ++i)
            if (st[i] % 8) return (int)cudaErrorMisalignedAddress;
        if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
            return (int)cudaErrorMisalignedAddress;
        return dispatch<__nv_bfloat16>(q, k, v, o, (float*)lse, valid_from, B, H, KV, S, T, hd, st,
                                       causal, window, q_off, cap, scale, (cudaStream_t)stream);
    }
    return (int)cudaErrorInvalidValue;
}

// ===========================================================================
// K7b — flash attention, backward, hand-written for Hopper (sm_90a).
//
// Replaces: no Pallas kernel.  The reference trains through its jnp
// blockwise_attention (src/repro/models/attention.py:73) under autodiff, the
// scan's reverse; the port trains through K7, whose output has no autograd
// graph, so the gradient of the same function is this kernel.  For each row
// i of query head h (KV head h / G), at position q_off + i among the T keys
// (K7's mask and offset), and key j, with the forward's scores
//   x_ij = q_i . k_j * scale,  s_ij = softcap(x_ij)  (cap * tanh(x / cap)),
// the row's log-sum-exp L_i (K7's lse output) and D_i = dO_i . O_i:
//   P_ij  = exp(s_ij - L_i) over the valid keys (K7's mask), else 0
//   dV_j  = sum_i round(P_ij) dO_i         (P rounded to V's type, as K7's P.V)
//   dS_ij = P_ij (dO_i . v_j - D_i) * (1 - tanh^2(x_ij / cap)) * scale
//   dQ_i  = sum_j dS_ij k_j,   dK_j = sum_i dS_ij q_i
// summed over the G query heads of a KV head for dK and dV.
//
// Three launches on the caller's stream: bwd_dot_kernel, D [B, H, S]
// float32 (one warp per row); a dK/dV pass over key tiles, whose CTA keeps
// its K and V tiles in shared memory while it walks the G query heads and
// every query tile that can see the keys (the causal diagonal and the
// window cut the walk), so a KV head's dK and dV are summed inside one CTA;
// a dQ pass over query tiles, whose CTA keeps Q and dO while it walks the
// key tiles the rows can see.  The scores and dP are computed in both
// passes (14 hd operations per valid pair against the 10 hd of the
// function): the price of keeping dQ out of atomics.  Determinism: each
// output element is summed by one thread (one accumulator register) in a
// fixed order, the heads and then the query tiles for dK and dV, the key
// tiles for dQ; no float atomic and no order that depends on scheduling
// enters a sum, so two runs on the same inputs give the same bits.
//
// What bounds it on the H100: the five products, 10 hd operations per valid
// pair (2.5 x the forward's 4 hd), against 989 TFLOP/s of bf16 tensor
// cores; the tensors cross device memory once each, far less at any
// training length.  Beside the products every pair takes, in each pass, an
// exp2, with the gemma2 cap an exact tanhf, and about a dozen FMAs on the
// FMA pipes: on the capped layers of the same order as the products, so
// none of it may go through shared memory.  Two bodies:
//   bfloat16 (training at the model's dtype) — bwd_dkdv_wgmma_kernel and
//   bwd_dq_wgmma_kernel below, K7's warp-specialised CTA: every product on
//   wgmma, its operands loaded by TMA through rings of stages that overlap
//   the copies with the products; the elementwise step in registers on the
//   accumulator fragments, masked only on tiles that cross a boundary; only
//   P^T and dS^T cross shared memory, as bf16 operands of the dK/dV pass's
//   products.  p is rounded to bf16 before dV (K7's rounding), dS before
//   dK and dQ (the price of the tensor cores).
//   float32 (the reduced configs and the parity cases) — bwd_dkdv_kernel
//   and bwd_dq_kernel: every product on the FMA pipes, 256 threads on
//   32 x 32 tiles, each thread 4 scores in the score phase and 32 dK + 32 dV
//   (or 32 dQ) accumulators over 8-column strides in the sum phase: about
//   one shared-memory load per FMA.
// ===========================================================================

#define BW_BQ 32
#define BW_BK 32
#define BW_THREADS 256

__device__ __forceinline__ float bw_load(const float* p) { return *p; }
__device__ __forceinline__ float bw_load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

static size_t bw_smem_bytes(int hd)
{
    const int ld = hd + 1;
    return sizeof(float) * ((size_t)(2 * BW_BQ + 2 * BW_BK) * ld + 2 * (size_t)BW_BQ * (BW_BK + 1) +
                            2 * BW_BQ);
}

// D_i = dO_i . O_i, rows of q's layout (b, h, i) by strides; D [B, H, S]
template <typename T>
__global__ void __launch_bounds__(BW_THREADS)
bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dsum,
               int H, int S, int hd, long long sb, long long sh, long long ss, long long rows)
{
    const long long row = (long long)blockIdx.x * (BW_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const int i = (int)(row % S);
    const long long bh = row / S;
    const int h = (int)(bh % H), b = (int)(bh / H);
    const long long off = b * sb + h * sh + i * ss;
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32) acc = fmaf(bw_load(o + off + d), bw_load(dout + off + d), acc);
#pragma unroll
    for (int sh2 = 16; sh2 >= 1; sh2 >>= 1) acc += __shfl_xor_sync(FULL_MASK, acc, sh2);
    if (lane == 0) dsum[row] = acc;
}

// rows [0, n) of a [rows][hd] tile from src (row stride rs) into dst [rows][ld]
__device__ __forceinline__ void bw_tile(float* dst, const float* src, int r0, int n_valid, int hd,
                                        long long rs, int rows)
{
    const int ld = hd + 1;
    for (int idx = threadIdx.x; idx < rows * hd; idx += BW_THREADS) {
        const int r = idx / hd, d = idx - r * hd;
        dst[r * ld + d] = r0 + r < n_valid ? src[(long long)(r0 + r) * rs + d] : 0.f;
    }
}

// The score phase shared by both kernels.  Thread (r = tid / 8, c0 = tid % 8)
// takes row r of the query tile and keys c0 + 8n (n < 4): recomputes x, s,
// P and dP; writes P to ps (when ps) and dS (with the scale and the cap's
// derivative folded in) to dss, both [BW_BQ][BW_BK + 1].
__device__ __forceinline__ void bw_scores(const float* qs, const float* dos, const float* ks,
                                          const float* vs, const float* lse_s, const float* d_s,
                                          float* ps, float* dss, int i0, int j0, int S, int T_,
                                          int hd, int causal, int window, int q_off, float cap,
                                          float scale)
{
    const int ld = hd + 1;
    const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7;
    float sx[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    const float* qrow = qs + r * ld;
    const float* dorow = dos + r * ld;
    for (int d = 0; d < hd; ++d) {
        const float qd = qrow[d], dod = dorow[d];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
            sx[n] = fmaf(qd, ks[(c0 + 8 * n) * ld + d], sx[n]);
            dp[n] = fmaf(dod, vs[(c0 + 8 * n) * ld + d], dp[n]);
        }
    }
    const int i = i0 + r, ip = q_off + i;  // the row and its position
    const float L = lse_s[r], Di = d_s[r];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
        const int c = c0 + 8 * n, j = j0 + c;
        bool ok = i < S && j < T_;
        if (causal) ok = ok && j <= ip;
        if (window >= 0) ok = ok && ip - j < window;
        const float x = sx[n] * scale;
        float s = x, dcap = 1.f;
        if (cap > 0.f) {
            const float t = tanhf(x / cap);
            s = cap * t;
            dcap = 1.f - t * t;
        }
        const float p = ok ? expf(s - L) : 0.f;
        if (ps != nullptr) ps[r * (BW_BK + 1) + c] = p;
        dss[r * (BW_BK + 1) + c] = p * (dp[n] - Di) * dcap * scale;
    }
}

template <int HDMAX>
__global__ void __launch_bounds__(BW_THREADS)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                float* __restrict__ dk, float* __restrict__ dv, int G, int S, int T_, int hd,
                long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
                long long kst, int causal, int window, int q_off, float cap, float scale)
{
    extern __shared__ float bw_smem[];
    const int ld = hd + 1;
    float* ks = bw_smem;               // [BW_BK][ld]
    float* vs = ks + BW_BK * ld;       // [BW_BK][ld]
    float* qs = vs + BW_BK * ld;       // [BW_BQ][ld]
    float* dos = qs + BW_BQ * ld;      // [BW_BQ][ld]
    float* ps = dos + BW_BQ * ld;      // [BW_BQ][BW_BK + 1]
    float* dss = ps + BW_BQ * (BW_BK + 1);
    float* lse_s = dss + BW_BQ * (BW_BK + 1);  // [BW_BQ]
    float* d_s = lse_s + BW_BQ;                 // [BW_BQ]

    const int kvh = blockIdx.y, b = blockIdx.z, j0 = blockIdx.x * BW_BK;
    const int H = gridDim.y * G;
    const float* kb = k + b * ksb + kvh * ksh;
    const float* vb = v + b * ksb + kvh * ksh;
    bw_tile(ks, kb, j0, T_, hd, kst, BW_BK);
    bw_tile(vs, vb, j0, T_, hd, kst, BW_BK);

    // the query rows that may see keys [j0, j0 + BW_BK): [i_lo, i_hi)
    const int i_lo = causal ? max(j0 - q_off, 0) : 0;
    int i_hi = S;
    if (window >= 0) i_hi = min(i_hi, j0 + BW_BK - 1 + window - q_off);

    const int c = threadIdx.x >> 3, e0 = threadIdx.x & 7;  // sum phase: key c, columns e0 + 8jj
    float adk[HDMAX / 8], adv[HDMAX / 8];
#pragma unroll
    for (int jj = 0; jj < HDMAX / 8; ++jj) adk[jj] = adv[jj] = 0.f;

    for (int g = 0; g < G; ++g) {
        const int h = kvh * G + g;
        const float* qb = q + b * qsb + h * qsh;
        const float* db = dout + b * qsb + h * qsh;
        const float* lrow = lse + ((long long)b * H + h) * S;
        const float* drow = dsum + ((long long)b * H + h) * S;
        for (int i0 = (i_lo / BW_BQ) * BW_BQ; i0 < i_hi; i0 += BW_BQ) {
            __syncthreads();  // the previous tile's readers are done
            bw_tile(qs, qb, i0, S, hd, qss, BW_BQ);
            bw_tile(dos, db, i0, S, hd, qss, BW_BQ);
            if (threadIdx.x < BW_BQ) {
                const int i = i0 + threadIdx.x;
                lse_s[threadIdx.x] = i < S ? lrow[i] : INFINITY;
                d_s[threadIdx.x] = i < S ? drow[i] : 0.f;
            }
            __syncthreads();
            bw_scores(qs, dos, ks, vs, lse_s, d_s, ps, dss, i0, j0, S, T_, hd, causal,
                         window, q_off, cap, scale);
            __syncthreads();
            for (int r = 0; r < BW_BQ; ++r) {
                const float p = ps[r * (BW_BK + 1) + c], ds = dss[r * (BW_BK + 1) + c];
                const float* dorow = dos + r * ld + e0;
                const float* qrow = qs + r * ld + e0;
#pragma unroll
                for (int jj = 0; jj < HDMAX / 8; ++jj) {
                    if (8 * jj + e0 < hd) {
                        adv[jj] = fmaf(p, dorow[8 * jj], adv[jj]);
                        adk[jj] = fmaf(ds, qrow[8 * jj], adk[jj]);
                    }
                }
            }
        }
    }
    const int j = j0 + c;
    if (j >= T_) return;
    float* dkrow = dk + b * ksb + kvh * ksh + j * kst;
    float* dvrow = dv + b * ksb + kvh * ksh + j * kst;
#pragma unroll
    for (int jj = 0; jj < HDMAX / 8; ++jj) {
        const int d = 8 * jj + e0;
        if (d < hd) {
            dkrow[d] = adk[jj];
            dvrow[d] = adv[jj];
        }
    }
}

template <int HDMAX>
__global__ void __launch_bounds__(BW_THREADS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              float* __restrict__ dq, int G, int S, int T_, int hd, long long qsb,
              long long qsh, long long qss, long long ksb, long long ksh, long long kst,
              int causal, int window, int q_off, float cap, float scale)
{
    extern __shared__ float bw_smem[];
    const int ld = hd + 1;
    float* ks = bw_smem;
    float* vs = ks + BW_BK * ld;
    float* qs = vs + BW_BK * ld;
    float* dos = qs + BW_BQ * ld;
    float* dss = dos + BW_BQ * ld;  // (no P tile here)
    float* lse_s = dss + 2 * BW_BQ * (BW_BK + 1);
    float* d_s = lse_s + BW_BQ;

    const int h = blockIdx.y, b = blockIdx.z;
    const int i0 = (gridDim.x - 1 - blockIdx.x) * BW_BQ;  // the longest rows first
    const int H = gridDim.y;
    const float* qb = q + b * qsb + h * qsh;
    const float* db = dout + b * qsb + h * qsh;
    const float* kb = k + b * ksb + (h / G) * ksh;
    const float* vb = v + b * ksb + (h / G) * ksh;
    bw_tile(qs, qb, i0, S, hd, qss, BW_BQ);
    bw_tile(dos, db, i0, S, hd, qss, BW_BQ);
    if (threadIdx.x < BW_BQ) {
        const int i = i0 + threadIdx.x;
        lse_s[threadIdx.x] = i < S ? lse[((long long)b * H + h) * S + i] : INFINITY;
        d_s[threadIdx.x] = i < S ? dsum[((long long)b * H + h) * S + i] : 0.f;
    }

    // the keys rows [i0, i0 + BW_BQ) may see: [j_lo, j_hi)
    const int i_last = min(i0 + BW_BQ, S) - 1;
    int j_lo = 0, j_hi = T_;
    if (causal) j_hi = min(j_hi, q_off + i_last + 1);
    if (window >= 0) j_lo = max(j_lo, q_off + i0 - window + 1);

    const int r = threadIdx.x >> 3, e0 = threadIdx.x & 7;  // sum phase: row r, columns e0 + 8jj
    float adq[HDMAX / 8];
#pragma unroll
    for (int jj = 0; jj < HDMAX / 8; ++jj) adq[jj] = 0.f;

    for (int j0 = (j_lo / BW_BK) * BW_BK; j0 < j_hi; j0 += BW_BK) {
        __syncthreads();  // the previous tile's readers are done (and Q, dO landed)
        bw_tile(ks, kb, j0, T_, hd, kst, BW_BK);
        bw_tile(vs, vb, j0, T_, hd, kst, BW_BK);
        __syncthreads();
        bw_scores(qs, dos, ks, vs, lse_s, d_s, nullptr, dss, i0, j0, S, T_, hd, causal,
                     window, q_off, cap, scale);
        __syncthreads();
        const float* dsrow = dss + r * (BW_BK + 1);
        for (int cc = 0; cc < BW_BK; ++cc) {
            const float ds = dsrow[cc];
            const float* krow = ks + cc * ld + e0;
#pragma unroll
            for (int jj = 0; jj < HDMAX / 8; ++jj)
                if (8 * jj + e0 < hd) adq[jj] = fmaf(ds, krow[8 * jj], adq[jj]);
        }
    }
    const int i = i0 + r;
    if (i >= S) return;
    float* dqrow = dq + b * qsb + h * qsh + i * qss;
#pragma unroll
    for (int jj = 0; jj < HDMAX / 8; ++jj) {
        const int d = 8 * jj + e0;
        if (d < hd) dqrow[d] = adq[jj];
    }
}

// ---------------------------------------------------------------------------
// bfloat16: two warp-specialised wgmma passes behind TMA rings
//
// Both passes take K7's CTA (TC_THREADS: two consumer warpgroups and a
// producer warpgroup whose registers go to the consumers by setmaxnreg),
// its tensor maps (boxes of Tc<HDP>::BOXC columns, swizzled as wgmma reads
// them, zero-filled past hd, S and T) and its operand descriptors.
//
// dK/dV pass (bwd_dkdv_wgmma_kernel): one CTA per (KV head, b, 64-key
// tile), the key tiles with the most query tiles (the first, under causal
// masking) issued first.  The producer warp loads K and V once, then
// streams the 64-row Q and dO tiles through a ring of Bk<HDP>::STAGES
// stages over the G query heads and the query tiles that can see the keys
// (causal, window and S cut the walk); its lanes stage each tile's lse (in
// the exp2 domain) and D beside it.  Per stage each consumer warpgroup
// computes S^T = K Q^T and dP^T = V dO^T (m64n32, both operands K-major)
// for its 32 of the 64 rows, runs the elementwise step on the accumulator
// fragments (the per-element mask only on tiles that cross the diagonal,
// the window edge, S or T), and writes its bf16 P^T and dS^T columns into
// two 128-byte-swizzled exchange tiles [64 keys][64 rows] (double-buffered
// by stage parity); the warpgroups meet at a named barrier, and then
// warpgroup 0 takes dV += P^T dO and warpgroup 1 dK += dS^T Q (m64n{HDP},
// A the exchange tile, B read MN-major from the stage, as K7 reads V).
// Each warpgroup holds one 64 x HDP float32 accumulator (HDP / 2 registers
// a thread); every score product is computed once.
//
// dQ pass (bwd_dq_wgmma_kernel): one CTA per (KV head and query-head pair,
// b, query tile), the longest rows first, as K7's forward: the consumer
// warpgroups own two query heads of one KV head at the same 64 rows (G >= 2;
// odd G leaves the last pair's second warpgroup idle) or two 64-row tiles
// of one head (G = 1).  Q and dO stay resident, with each row's lse and D
// in registers; K and V stream through a ring of Bq<HDP>::BK-key stages (32
// keys at HDP 256, where Q and dO of two heads take 128 KB; 64 below).
// Per stage: S = Q K^T and dP = dO V^T, the elementwise step in registers,
// dS rounded to bf16 and repacked as the register A operand, dQ += dS K
// with K read MN-major.
// ---------------------------------------------------------------------------

#define BB_ROWS 64  // keys of a dK/dV CTA; rows of a dK/dV stage and of a dQ warpgroup

template <int HDP> struct Bk {  // the dK/dV pass
    using C = Tc<HDP>;
    static constexpr int STAGES = HDP == 256 ? 2 : 4;
    static constexpr int XT = 64 * 128;  // bytes of one [64 keys][64 rows] bf16 exchange tile
    // the alignment slack, K, V, the stages' Q and dO, the exchange tiles
    // [2][P^T, dS^T], the stages' lse and D [64] float32, kvfull full[STAGES]
    // empty[STAGES]: 231,464 bytes at HDP 256 (two stages), 199,752 at 128 (four)
    static constexpr size_t SMEM = 1024 + (size_t)(2 + 2 * STAGES) * C::TILE + 4 * XT +
                                   512 * STAGES + 8 * (1 + 2 * STAGES);
};

template <int HDP> struct Bq {  // the dQ pass
    using C = Tc<HDP>;
    static constexpr int BK = HDP == 256 ? 32 : 64;  // keys of one stage
    static constexpr int KBOX = BK * C::RB;          // bytes of one box of BK rows
    static constexpr int KTILE = C::NBOX * KBOX;
    static constexpr int STAGES = HDP == 256 ? 3 : 4;
    // the alignment slack, Q [2], dO [2], the stages' K and V, full[STAGES]
    // empty[STAGES] qfull[2]: 230,464 bytes at HDP 256, 197,712 at 128
    static constexpr size_t SMEM =
        1024 + 4 * (size_t)C::TILE + 2 * (size_t)STAGES * KTILE + 8 * (2 * STAGES + 2);
};

// S^T (+)= K.Q^T over 32 rows (dK/dV pass) and S (+)= Q.K^T over 32 keys
// (dQ pass at HDP 256): m64n32k16, both operands K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " %16, %17, p, 1, 1, 0, 0;\n}\n"
        : WG_F16(d, 0)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// dV += P^T.dO and dK += dS^T.Q: m64n{N}k16, A K-major and B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_ss_t(float (&d)[8], uint64_t desc_a, uint64_t desc_b)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        " %8, %9, p, 1, 1, 0, 1;\n}\n"
        : WG_F8(d, 0)
        : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_t(float (&d)[16], uint64_t desc_a, uint64_t desc_b)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " %16, %17, p, 1, 1, 0, 1;\n}\n"
        : WG_F16(d, 0)
        : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_t(float (&d)[32], uint64_t desc_a, uint64_t desc_b)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, 0, 1;\n}\n"
        : WG_F32(d, 0)
        : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_t(float (&d)[64], uint64_t desc_a, uint64_t desc_b)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, p, 1, 1, 0, 1;\n}\n"
        : WG_F64(d, 0)
        : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_t(float (&d)[128], uint64_t desc_a, uint64_t desc_b)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127},"
        " %128, %129, p, 1, 1, 0, 1;\n}\n"
        : WG_F128(d, 0)
        : "l"(desc_a), "l"(desc_b), "r"(1));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi)
{
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// One score of the backward from x = q.k and dp = dO.v, with its row's lse
// (in the exp2 domain, L2) and D: p = exp(s - lse), 0 where masked, and
// ds = p (dp - D) softcap'(x) scale.  As in K7, s is kept in the exp2
// domain: cap_l2 tanh(x scale / cap) (exact tanhf) or x scale log2(e).
__device__ __forceinline__ void bwd_score(float x, float dp, float L2, float D, bool ok,
                                          float cap_l2, float sc, float scale, float& p,
                                          float& ds)
{
    float s, g = scale;
    if (cap_l2 > 0.f) {
        const float t = tanhf(x * sc);
        s = cap_l2 * t;
        g = scale * (1.f - t * t);
    } else {
        s = x * sc;
    }
    p = ok ? exp2f(s - L2) : 0.f;
    ds = p * (dp - D) * g;
}

// One stage of the dK/dV pass for consumer warpgroup wg: S^T and dP^T of
// the CTA's 64 keys against the stage's rows [wg * 32, wg * 32 + 32) (qdesc,
// ddesc already offset to them), the elementwise step, and P^T and dS^T
// (bf16) into the exchange tiles at pt and pt + XT.  This thread's keys are
// kr0 and kr0 + 8 of the tile, its rows wg * 32 + 8n + cq (+ 1).  MASK: the
// tile crosses the diagonal, the window edge, S or T.
template <int HDP, bool MASK>
__device__ __forceinline__ void bk_scores(uint64_t kdesc, uint64_t vdesc, uint64_t qdesc,
                                          uint64_t ddesc, const float* lds, uint32_t pt,
                                          int wg, int kr0, int cq, int j0, int i0, int S,
                                          int T_, int causal, int window, int q_off,
                                          float cap_l2, float sc, float scale)
{
    using C = Tc<HDP>;
    float st[16], dpt[16];
#pragma unroll
    for (int n = 0; n < 16; ++n) st[n] = dpt[n] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t off = ((kk / C::KPR) * C::BOX + (kk % C::KPR) * 32) >> 4;
        wgmma_ss(st, kdesc + off, qdesc + off, 1);
    }
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t off = ((kk / C::KPR) * C::BOX + (kk % C::KPR) * 32) >> 4;
        wgmma_ss(dpt, vdesc + off, ddesc + off, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

#pragma unroll
    for (int n = 0; n < 4; ++n) {
        const int c = wg * 32 + 8 * n + cq;  // the stage rows of this block: c, c + 1
        const float2 L = *reinterpret_cast<const float2*>(lds + c);
        const float2 D = *reinterpret_cast<const float2*>(lds + 64 + c);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            bool ok = true;
            if (MASK) {
                const int i = i0 + c + (e & 1), j = j0 + kr0 + (e < 2 ? 0 : 8);
                ok = i < S && j < T_;
                if (causal) ok = ok && j <= q_off + i;
                if (window >= 0) ok = ok && q_off + i - j < window;
            }
            bwd_score(st[4 * n + e], dpt[4 * n + e], e & 1 ? L.y : L.x, e & 1 ? D.y : D.x, ok,
                      cap_l2, sc, scale, p[e], ds[e]);
        }
        // rows kr0 and kr0 + 8 (the same phase of the swizzle), 16-byte chunk
        // wg * 4 + n of the 128-byte row
        const uint32_t a0 = pt + kr0 * 128 + (((uint32_t)(wg * 4 + n) ^ (kr0 & 7)) << 4) + cq * 2;
        st_shared_u32(a0, pack_bf16(p[0], p[1]));
        st_shared_u32(a0 + 8 * 128, pack_bf16(p[2], p[3]));
        st_shared_u32(a0 + Bk<HDP>::XT, pack_bf16(ds[0], ds[1]));
        st_shared_u32(a0 + Bk<HDP>::XT + 8 * 128, pack_bf16(ds[2], ds[3]));
    }
}

template <int HDP>
__global__ void __launch_bounds__(TC_THREADS, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap dmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const float* __restrict__ lse,
                      const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int G, int H, int S, int T_, int hd,
                      long long ksb, long long ksh, long long kst, int causal, int window,
                      int q_off, float cap, float scale)
{
    using C = Tc<HDP>;
    using P = Bk<HDP>;
    extern __shared__ unsigned char tc_smem[];
    const uint32_t base = smem_u32(tc_smem);
    const uint32_t k_sm = (base + 1023u) & ~1023u;
    const uint32_t v_sm = k_sm + C::TILE;
    const uint32_t q_sm = v_sm + C::TILE;              // [STAGES][TILE]
    const uint32_t d_sm = q_sm + P::STAGES * C::TILE;  // [STAGES][TILE]
    const uint32_t x_sm = d_sm + P::STAGES * C::TILE;  // [2][P^T, dS^T]
    const uint32_t l_sm = x_sm + 4 * P::XT;            // [STAGES][lse 64, D 64]
    const uint32_t kvfull = l_sm + 512 * P::STAGES;
    const uint32_t full = kvfull + 8;                  // + 8 s
    const uint32_t empty = full + 8 * P::STAGES;       // + 8 s
    float* const l_all = reinterpret_cast<float*>(tc_smem + (l_sm - base));

    const int kvh = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * BB_ROWS;
    // the query tiles of each head that can see keys [j0, j0 + 64): nqt from qt_lo
    const int i_lo = causal ? max(j0 - q_off, 0) : 0;
    int i_hi = S;
    if (window >= 0) i_hi = min(i_hi, j0 + BB_ROWS - 1 + window - q_off);
    const int qt_lo = i_lo / BB_ROWS;
    const int nqt = i_lo < i_hi ? (i_hi + BB_ROWS - 1) / BB_ROWS - qt_lo : 0;
    const int n_it = G * nqt;  // stages: head g = it / nqt, tile qt_lo + it % nqt

    const int tid = threadIdx.x;
    if (tid == 0) {
        mbar_init(kvfull, 1);
#pragma unroll
        for (int s = 0; s < P::STAGES; ++s) {
            mbar_init(full + 8 * s, 32);  // the producer warp's lanes, one with the bytes
            mbar_init(empty + 8 * s, 8);  // each consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= 2 * 128) {
        // producer warpgroup: its first warp; lane 0 issues every copy
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (tid >= 2 * 128 + 32 || n_it == 0) return;
        const int lane = tid & 31;
        if (lane == 0) {
            mbar_expect_tx(kvfull, 2 * C::TILE);
#pragma unroll
            for (int c = 0; c < C::NBOX; ++c) {
                tma_load(k_sm + c * C::BOX, &kmap, kvfull, c * C::BOXC, j0, kvh, b);
                tma_load(v_sm + c * C::BOX, &vmap, kvfull, c * C::BOXC, j0, kvh, b);
            }
        }
        for (int it = 0; it < n_it; ++it) {
            const int g = it / nqt, i0 = (qt_lo + it - g * nqt) * BB_ROWS, h = kvh * G + g;
            const int s = it % P::STAGES;
            if (it >= P::STAGES) mbar_wait(empty + 8 * s, (it / P::STAGES - 1) & 1);
            const long long row = ((long long)b * H + h) * S;
            float* lds = l_all + 128 * s;
            for (int r = lane; r < BB_ROWS; r += 32) {
                const int i = i0 + r;
                lds[r] = i < S ? lse[row + i] * TC_LOG2E : 0.f;
                lds[64 + r] = i < S ? dsum[row + i] : 0.f;
            }
            const uint32_t bar = full + 8 * s;
            if (lane == 0) {
                mbar_expect_tx(bar, 2 * C::TILE);
#pragma unroll
                for (int c = 0; c < C::NBOX; ++c) {
                    tma_load(q_sm + s * C::TILE + c * C::BOX, &qmap, bar, c * C::BOXC, i0, h, b);
                    tma_load(d_sm + s * C::TILE + c * C::BOX, &dmap, bar, c * C::BOXC, i0, h, b);
                }
            } else {
                mbar_arrive(bar);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
        const int wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
        const int kr0 = warp * 16 + (lane >> 2);  // this thread's keys: kr0, kr0 + 8
        const int cq = 2 * (lane & 3);
        const float cap_l2 = cap > 0.f ? cap * TC_LOG2E : 0.f;
        const float sc = cap > 0.f ? scale / cap : scale * TC_LOG2E;
        const uint64_t kdesc = smem_desc<C::LAYOUT>(k_sm, 16, 8 * C::RB);
        const uint64_t vdesc = smem_desc<C::LAYOUT>(v_sm, 16, 8 * C::RB);
        // warpgroup 0 sums dV, warpgroup 1 dK: 64 keys x HDP
        float acc[HDP / 2];
#pragma unroll
        for (int n = 0; n < HDP / 2; ++n) acc[n] = 0.f;
        if (n_it > 0) mbar_wait(kvfull, 0);

        for (int it = 0; it < n_it; ++it) {
            const int g = it / nqt, i0 = (qt_lo + it - g * nqt) * BB_ROWS;
            const int s = it % P::STAGES;
            mbar_wait(full + 8 * s, (it / P::STAGES) & 1);
            const uint32_t qs = q_sm + s * C::TILE, dos = d_sm + s * C::TILE;
            const uint32_t pt = x_sm + (it & 1) * 2 * P::XT;
            const int qa = i0 + wg * 32;  // this warpgroup's rows of the scores: qa .. qa + 31
            const uint64_t qdesc = smem_desc<C::LAYOUT>(qs + wg * 32 * C::RB, 16, 8 * C::RB);
            const uint64_t ddesc = smem_desc<C::LAYOUT>(dos + wg * 32 * C::RB, 16, 8 * C::RB);
            const float* lds = l_all + 128 * s;
            const bool inner = qa + 32 <= S && j0 + BB_ROWS <= T_ &&
                               (!causal || j0 + BB_ROWS - 1 <= q_off + qa) &&
                               (window < 0 || q_off + qa + 31 - j0 < window);
            if (inner)
                bk_scores<HDP, false>(kdesc, vdesc, qdesc, ddesc, lds, pt, wg, kr0, cq, j0, i0,
                                      S, T_, causal, window, q_off, cap_l2, sc, scale);
            else
                bk_scores<HDP, true>(kdesc, vdesc, qdesc, ddesc, lds, pt, wg, kr0, cq, j0, i0,
                                     S, T_, causal, window, q_off, cap_l2, sc, scale);
            // both warpgroups' halves of P^T and dS^T are in place (and visible
            // to the tensor cores' reads)
            fence_proxy_async();
            named_bar_sync(1, 256);
            // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1) over the
            // stage's 64 rows; B MN-major: the next 64 columns one box on (LBO),
            // the next 8 rows 8 rows on (SBO)
            const uint64_t adesc = smem_desc<1>(pt + wg * P::XT, 16, 8 * 128);
            const uint64_t bdesc = smem_desc<C::LAYOUT>(wg == 0 ? dos : qs, C::BOX, 8 * C::RB);
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BB_ROWS / 16; ++kk)
                wgmma_ss_t(acc, adesc + ((uint32_t)(kk * 32) >> 4),
                           bdesc + ((uint32_t)(kk * 16 * C::RB) >> 4));
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(acc);
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + 8 * s);
        }

        __nv_bfloat16* ob = (wg == 0 ? dv : dk) + b * ksb + kvh * ksh;
        const int j = j0 + kr0;
#pragma unroll
        for (int n = 0; n < HDP / 8; ++n) {
            const int d = n * 8 + cq;
            if (d >= hd) break;
            if (j < T_)
                *reinterpret_cast<__nv_bfloat162*>(ob + j * kst + d) =
                    __floats2bfloat162_rn(acc[4 * n], acc[4 * n + 1]);
            if (j + 8 < T_)
                *reinterpret_cast<__nv_bfloat162*>(ob + (j + 8) * kst + d) =
                    __floats2bfloat162_rn(acc[4 * n + 2], acc[4 * n + 3]);
        }
    }
}

// One key stage of the dQ pass for one consumer warpgroup: this thread's
// rows sit at positions i0 and i0 + 8 (lse L0, L1 in the exp2 domain; D0, D1), its keys
// j0 + 8n + cq (+ 1).  MASK as in bk_scores.
template <int HDP, bool MASK>
__device__ __forceinline__ void bq_tile(float (&acc)[HDP / 2], uint64_t qdesc, uint64_t ddesc,
                                        uint32_t ks, uint32_t vs, int j0, int i0, int cq,
                                        float L0, float L1, float D0, float D1, int T_,
                                        int causal, int window, float cap_l2, float sc,
                                        float scale)
{
    using C = Tc<HDP>;
    using P = Bq<HDP>;
    constexpr int NS = P::BK / 2;  // score registers a thread
    float s[NS], dp[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n] = dp[n] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    const uint64_t kdesc = smem_desc<C::LAYOUT>(ks, 16, 8 * C::RB);
    const uint64_t vdesc = smem_desc<C::LAYOUT>(vs, 16, 8 * C::RB);
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t ao = ((kk / C::KPR) * C::BOX + (kk % C::KPR) * 32) >> 4;
        const uint32_t bo = ((kk / C::KPR) * P::KBOX + (kk % C::KPR) * 32) >> 4;
        wgmma_ss(s, qdesc + ao, kdesc + bo, 1);
    }
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t ao = ((kk / C::KPR) * C::BOX + (kk % C::KPR) * 32) >> 4;
        const uint32_t bo = ((kk / C::KPR) * P::KBOX + (kk % C::KPR) * 32) >> 4;
        wgmma_ss(dp, ddesc + ao, vdesc + bo, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS rounded to bf16, packed as the A operand: da[2n] row i0, da[2n + 1]
    // row i0 + 8, of the 8-key block n (K7's packing of P)
    uint32_t da[NS / 2];
#pragma unroll
    for (int n = 0; n < P::BK / 8; ++n) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            bool ok = true;
            if (MASK) {
                const int i = e < 2 ? i0 : i0 + 8, j = j0 + 8 * n + cq + (e & 1);
                ok = j < T_;
                if (causal) ok = ok && j <= i;
                if (window >= 0) ok = ok && i - j < window;
            }
            float p;
            bwd_score(s[4 * n + e], dp[4 * n + e], e < 2 ? L0 : L1, e < 2 ? D0 : D1, ok, cap_l2,
                      sc, scale, p, ds[e]);
        }
        da[2 * n] = pack_bf16(ds[0], ds[1]);
        da[2 * n + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dQ += dS K with K MN-major: the next 64 columns one box on, the next 8
    // keys 8 rows on
    const uint64_t kmn = smem_desc<C::LAYOUT>(ks, P::KBOX, 8 * C::RB);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P::BK / 16; ++kk) {
        const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]};
        wgmma_rs(acc, a, kmn + ((uint32_t)(kk * 16 * C::RB) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
}

template <int HDP>
__global__ void __launch_bounds__(TC_THREADS, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap dmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const float* __restrict__ lse,
                    const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq, int G, int H,
                    int S, int T_, int hd, long long qsb, long long qsh, long long qss,
                    int causal, int window, int q_off, float cap, float scale)
{
    using C = Tc<HDP>;
    using P = Bq<HDP>;
    extern __shared__ unsigned char tc_smem[];
    const uint32_t q_sm = (smem_u32(tc_smem) + 1023u) & ~1023u;  // [2][TILE]
    const uint32_t d_sm = q_sm + 2 * C::TILE;                     // [2][TILE]
    const uint32_t k_sm = d_sm + 2 * C::TILE;                     // [STAGES][KTILE]
    const uint32_t v_sm = k_sm + P::STAGES * P::KTILE;            // [STAGES][KTILE]
    const uint32_t full = v_sm + P::STAGES * P::KTILE;            // + 8 s
    const uint32_t empty = full + 8 * P::STAGES;                  // + 8 s
    const uint32_t qfull = empty + 8 * P::STAGES;                 // + 8 w

    const int NP = G == 1 ? 1 : (G + 1) / 2;
    const int kvh = blockIdx.x / NP, pair = blockIdx.x - kvh * NP, b = blockIdx.y;
    const int qt = gridDim.z - 1 - blockIdx.z;
    // the two consumer warpgroups: head, first row, activity, key tiles
    const int head0 = G == 1 ? kvh : kvh * G + 2 * pair, head1 = G == 1 ? kvh : head0 + 1;
    const int qa0 = G == 1 ? qt * 2 * BB_ROWS : qt * BB_ROWS, qa1 = G == 1 ? qa0 + BB_ROWS : qa0;
    const bool act0 = qa0 < S, act1 = (G == 1 || 2 * pair + 1 < G) && qa1 < S;
    int lo0, hi0, lo1, hi1;
    key_tiles<P::BK>(qa0, S, T_, 0, causal, window, q_off, lo0, hi0);
    key_tiles<P::BK>(qa1, S, T_, 0, causal, window, q_off, lo1, hi1);
    if (!act1) lo1 = hi1 = 0;
    int u_lo = INT_MAX, u_hi = 0;  // the union the producer loads
    if (lo0 < hi0) u_lo = lo0, u_hi = hi0;
    if (lo1 < hi1) u_lo = min(u_lo, lo1), u_hi = max(u_hi, hi1);
    if (u_lo >= u_hi) u_lo = u_hi = 0;

    const int tid = threadIdx.x;
    if (tid == 0) {
#pragma unroll
        for (int s = 0; s < P::STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, 4 * (act0 + act1));  // each consumer warp releases
        }
        mbar_init(qfull, 1);
        mbar_init(qfull + 8, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= 2 * 128) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (tid == 2 * 128) {
            if (lo0 < hi0) {
                mbar_expect_tx(qfull, 2 * C::TILE);
#pragma unroll
                for (int c = 0; c < C::NBOX; ++c) {
                    tma_load(q_sm + c * C::BOX, &qmap, qfull, c * C::BOXC, qa0, head0, b);
                    tma_load(d_sm + c * C::BOX, &dmap, qfull, c * C::BOXC, qa0, head0, b);
                }
            }
            if (lo1 < hi1) {
                mbar_expect_tx(qfull + 8, 2 * C::TILE);
#pragma unroll
                for (int c = 0; c < C::NBOX; ++c) {
                    tma_load(q_sm + C::TILE + c * C::BOX, &qmap, qfull + 8, c * C::BOXC, qa1,
                             head1, b);
                    tma_load(d_sm + C::TILE + c * C::BOX, &dmap, qfull + 8, c * C::BOXC, qa1,
                             head1, b);
                }
            }
            for (int t = u_lo; t < u_hi; ++t) {
                const int i = t - u_lo, s = i % P::STAGES;
                if (i >= P::STAGES) mbar_wait(empty + 8 * s, (i / P::STAGES - 1) & 1);
                const uint32_t bar = full + 8 * s;
                mbar_expect_tx(bar, 2 * P::KTILE);
#pragma unroll
                for (int c = 0; c < C::NBOX; ++c) {
                    tma_load(k_sm + s * P::KTILE + c * P::KBOX, &kmap, bar, c * C::BOXC,
                             t * P::BK, kvh, b);
                    tma_load(v_sm + s * P::KTILE + c * P::KBOX, &vmap, bar, c * C::BOXC,
                             t * P::BK, kvh, b);
                }
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
        const int wg = tid >> 7;
        if (!(wg == 0 ? act0 : act1)) return;  // odd G: no head for this warpgroup
        const int head = wg == 0 ? head0 : head1, qa = wg == 0 ? qa0 : qa1;
        const int my_lo = wg == 0 ? lo0 : lo1, my_hi = wg == 0 ? hi0 : hi1;
        const int warp = (tid & 127) >> 5, lane = tid & 31;
        const int i0 = qa + warp * 16 + (lane >> 2);  // rows i0 and i0 + 8
        const int cq = 2 * (lane & 3);               // keys cq, cq + 1 of each 8
        const float cap_l2 = cap > 0.f ? cap * TC_LOG2E : 0.f;
        const float sc = cap > 0.f ? scale / cap : scale * TC_LOG2E;
        const long long row = ((long long)b * H + head) * S;
        const float L0 = i0 < S ? lse[row + i0] * TC_LOG2E : 0.f;
        const float L1 = i0 + 8 < S ? lse[row + i0 + 8] * TC_LOG2E : 0.f;
        const float D0 = i0 < S ? dsum[row + i0] : 0.f;
        const float D1 = i0 + 8 < S ? dsum[row + i0 + 8] : 0.f;
        const uint64_t qdesc = smem_desc<C::LAYOUT>(q_sm + wg * C::TILE, 16, 8 * C::RB);
        const uint64_t ddesc = smem_desc<C::LAYOUT>(d_sm + wg * C::TILE, 16, 8 * C::RB);

        float acc[HDP / 2];
#pragma unroll
        for (int n = 0; n < HDP / 2; ++n) acc[n] = 0.f;
        if (my_lo < my_hi) mbar_wait(qfull + 8 * wg, 0);

        for (int t = u_lo; t < u_hi; ++t) {
            const int i = t - u_lo, s = i % P::STAGES;
            mbar_wait(full + 8 * s, (i / P::STAGES) & 1);
            if (t >= my_lo && t < my_hi) {
                const int j0 = t * P::BK;
                const uint32_t ks = k_sm + s * P::KTILE, vs = v_sm + s * P::KTILE;
                const int pa = q_off + qa;  // the tile's first position
                const bool inner = j0 + P::BK <= T_ && (!causal || j0 + P::BK - 1 <= pa) &&
                                   (window < 0 || pa + BB_ROWS - 1 - j0 < window);
                if (inner)
                    bq_tile<HDP, false>(acc, qdesc, ddesc, ks, vs, j0, q_off + i0, cq, L0, L1,
                                        D0, D1, T_, causal, window, cap_l2, sc, scale);
                else
                    bq_tile<HDP, true>(acc, qdesc, ddesc, ks, vs, j0, q_off + i0, cq, L0, L1,
                                       D0, D1, T_, causal, window, cap_l2, sc, scale);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + 8 * s);
        }

        __nv_bfloat16* ob = dq + b * qsb + head * qsh;
#pragma unroll
        for (int n = 0; n < HDP / 8; ++n) {
            const int d = n * 8 + cq;
            if (d >= hd) break;
            if (i0 < S)
                *reinterpret_cast<__nv_bfloat162*>(ob + i0 * qss + d) =
                    __floats2bfloat162_rn(acc[4 * n], acc[4 * n + 1]);
            if (i0 + 8 < S)
                *reinterpret_cast<__nv_bfloat162*>(ob + (i0 + 8) * qss + d) =
                    __floats2bfloat162_rn(acc[4 * n + 2], acc[4 * n + 3]);
        }
    }
}

// the bf16 passes at HDP (hd rounded up to a compiled width); q, dout and
// dq share q's strides st[0..2], k, v, dk and dv k's st[3..5]
template <int HDP>
static int launch_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* dsum, void* dq, void* dk, void* dv,
                           int B, int H, int KV, int S, int T_, int hd, const long long* st,
                           int causal, int window, int q_off, float cap, float scale,
                           int passes, cudaStream_t stream)
{
    const auto kkv = bwd_dkdv_wgmma_kernel<HDP>;
    const auto kq = bwd_dq_wgmma_kernel<HDP>;
    static bool raised = false;
    if (!raised) {
        cudaError_t err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)Bk<HDP>::SMEM);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)Bq<HDP>::SMEM);
        if (err != cudaSuccess) return (int)err;
        raised = true;
    }
    const int G = H / KV;
    if (B > 65535) return (int)cudaErrorInvalidConfiguration;
    CUtensorMap qm, dm, km, vm;
    int rc = tile_map<HDP>(&qm, q, B, H, S, hd, st[0], st[1], st[2]);
    if (rc == 0) rc = tile_map<HDP>(&dm, dout, B, H, S, hd, st[0], st[1], st[2]);
    if (rc == 0) rc = tile_map<HDP>(&km, k, B, KV, T_, hd, st[3], st[4], st[5]);
    if (rc == 0) rc = tile_map<HDP>(&vm, v, B, KV, T_, hd, st[3], st[4], st[5]);
    if (rc != 0) return rc;
    if (passes & 2) {
        const dim3 grid(KV, B, (T_ + BB_ROWS - 1) / BB_ROWS);
        kkv<<<grid, TC_THREADS, Bk<HDP>::SMEM, stream>>>(
            qm, dm, km, vm, lse, dsum, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, G, H, S, T_, hd,
            st[3], st[4], st[5], causal, window, q_off, cap, scale);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (passes & 4) {
        // K and V in stages of Bq<HDP>::BK keys
        if (Bq<HDP>::BK != BB_ROWS) {
            rc = tile_map<HDP>(&km, k, B, KV, T_, hd, st[3], st[4], st[5], Bq<HDP>::BK);
            if (rc == 0) rc = tile_map<HDP>(&vm, v, B, KV, T_, hd, st[3], st[4], st[5], Bq<HDP>::BK);
            if (rc != 0) return rc;
        }
        const int rows = G == 1 ? 2 * BB_ROWS : BB_ROWS;  // query rows of one CTA
        const dim3 grid(KV * (G == 1 ? 1 : (G + 1) / 2), B, (S + rows - 1) / rows);
        kq<<<grid, TC_THREADS, Bq<HDP>::SMEM, stream>>>(
            qm, dm, km, vm, lse, dsum, (__nv_bfloat16*)dq, G, H, S, T_, hd, st[0], st[1], st[2],
            causal, window, q_off, cap, scale);
    }
    return (int)cudaGetLastError();
}

template <typename T, int HDMAX>
static int launch_bwd(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* dsum, void* dq, void* dk,
                      void* dv, int B, int H, int KV, int S, int T_, int hd, const long long* st,
                      int causal, int window, int q_off, float cap, float scale, int passes,
                      cudaStream_t stream)
{
    cudaError_t err;
    if (passes & 1) {
        const long long rows = (long long)B * H * S;
        bwd_dot_kernel<T><<<(unsigned)((rows + BW_THREADS / 32 - 1) / (BW_THREADS / 32)),
                            BW_THREADS, 0, stream>>>((const T*)o, (const T*)dout, dsum, H, S, hd,
                                                     st[0], st[1], st[2], rows);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if constexpr (std::is_same<T, float>::value) {
        const int G = H / KV;
        const auto kdkdv = bwd_dkdv_kernel<HDMAX>;
        const auto kdq = bwd_dq_kernel<HDMAX>;
        const size_t smem = bw_smem_bytes(hd);
        static bool raised = false;  // per instantiation: raise once, to the widest launch
        if (smem > 48 * 1024 && !raised) {
            err = cudaFuncSetAttribute(kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bw_smem_bytes(HDMAX));
            if (err == cudaSuccess)
                err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bw_smem_bytes(HDMAX));
            if (err != cudaSuccess) return (int)err;
            raised = true;
        }
        if (passes & 2) {
            const dim3 gkv((T_ + BW_BK - 1) / BW_BK, KV, B);
            kdkdv<<<gkv, BW_THREADS, smem, stream>>>(
                (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, (T*)dk,
                (T*)dv, G, S, T_, hd, st[0], st[1], st[2], st[3], st[4], st[5], causal, window,
                q_off, cap, scale);
            err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
        if (passes & 4) {
            const dim3 gq((S + BW_BQ - 1) / BW_BQ, H, B);
            kdq<<<gq, BW_THREADS, smem, stream>>>(
                (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, (T*)dq, G, S,
                T_, hd, st[0], st[1], st[2], st[3], st[4], st[5], causal, window, q_off, cap,
                scale);
        }
        return (int)cudaGetLastError();
    } else {
        return launch_bwd_bf16<HDMAX>(q, k, v, dout, lse, dsum, dq, dk, dv, B, H, KV, S, T_, hd,
                                      st, causal, window, q_off, cap, scale, passes, stream);
    }
}

template <typename T>
static int dispatch_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* dsum, void* dq, void* dk,
                        void* dv, int B, int H, int KV, int S, int T_, int hd,
                        const long long* st, int causal, int window, int q_off, float cap,
                        float scale, int passes, cudaStream_t stream)
{
#define BW_CASE(W)                                                                          \
    if (hd <= W)                                                                            \
        return launch_bwd<T, W>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, KV, S, T_,   \
                                hd, st, causal, window, q_off, cap, scale, passes, stream);
    BW_CASE(16) BW_CASE(32) BW_CASE(64) BW_CASE(128) BW_CASE(256)
#undef BW_CASE
    return (int)cudaErrorInvalidValue;
}

// q, o, dout and dq [B, H, S, hd] by strides (qsb, qsh, qss); k, v, dk and
// dv [B, KV, T, hd] by strides (ksb, ksh, kst); the hd axis contiguous.
// lse [B, H, S] float32 from K7's forward on the same q, k, v (no row
// without a valid key: training has no left pads); dsum [B, H, S] float32
// scratch (D).  dtype 0 = float32, 1 = bfloat16 (every tensor but lse and
// dsum); for bfloat16, TMA reads q, k, v and dout: 16-byte aligned bases
// and strides in multiples of 8 elements.  window, cap and q_off (q_off +
// S <= T) as the forward's.  passes: a mask of the launches to make in order, 1 the D
// pass, 2 the dK/dV pass, 4 the dQ pass (7: the whole backward; a later
// pass reads what an earlier one wrote).  Launches on `stream` and returns
// the first error of a launch (0 on success).
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dsum, void* dq, void* dk, void* dv, int dtype, int B, int H, int KV,
    int S, int T, int hd, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kst, int causal, int window, int q_off, float cap, float scale,
    int passes, void* stream)
{
    if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV || hd < 8 || hd > 256 || hd % 8 ||
        passes < 1 || passes > 7 || q_off < 0 || q_off + S > T)
        return (int)cudaErrorInvalidValue;
    const long long st[6] = {qsb, qsh, qss, ksb, ksh, kst};
    if (dtype == 0)
        return dispatch_bwd<float>(q, k, v, o, dout, (const float*)lse, (float*)dsum, dq, dk,
                                   dv, B, H, KV, S, T, hd, st, causal, window, q_off, cap,
                                   scale, passes, (cudaStream_t)stream);
    if (dtype == 1) {
        for (int i = 0; i < 6; ++i)
            if (st[i] % 8) return (int)cudaErrorMisalignedAddress;
        if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)dout) % 16)
            return (int)cudaErrorMisalignedAddress;
        return dispatch_bwd<__nv_bfloat16>(q, k, v, o, dout, (const float*)lse, (float*)dsum,
                                           dq, dk, dv, B, H, KV, S, T, hd, st, causal, window,
                                           q_off, cap, scale, passes, (cudaStream_t)stream);
    }
    return (int)cudaErrorInvalidValue;
}
