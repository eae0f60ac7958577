// K7 — flash attention, forward, hand-written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (body
// _flash_kernel), and serves the reference's model-layout scan
// src/repro/models/attention.py:blockwise_attention on the prefill path.
// For each batch row b, query head h (KV head h / G: no repeated K/V) and
// query i < S:
//   s_ij = softcap(q_i . k_j * scale),  softcap(x) = cap * tanh(x / cap)
//   key j valid iff  j < T  and  j >= valid_from[b]
//                    and (causal => j <= i)  and (window >= 0 => i - j < window)
//   o_i  = sum_j p_ij v_j / sum_j p_ij over valid j, by an online softmax
//          over key tiles with a float32 running max and sum (-2^30 for
//          "no key yet", as in the reference);
//   p_ij is rounded to V's type before P.V and the running sum adds the
//   rounded p (blockwise_attention's rounding; a no-op in float32);
//   a query row with no valid key (a left pad) is written as 0.
// Tiles of keys wholly above the diagonal, wholly outside the window or
// wholly before valid_from are never read (the key range of a query tile is
// cut before the loop, as pl.when(run) skips blocks).  causal, window,
// logit cap, valid_from, S, T, the strides and the scale are launch
// arguments: none forces a rebuild.  The head dim hd (a multiple of 8 up
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
#include <mma.h>

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
                 int causal, int window, float cap, float scale)
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
    const int i = q0 + r;

    for (int idx = tid; idx < FA_BQ * hd; idx += FA_THREADS) {
        const int rr = idx / hd, d = idx - rr * hd;
        qs[rr * ld + d] = q0 + rr < S ? qb[(q0 + rr) * qss + d] : 0.f;
    }

    // the keys any row of this tile may see: [k_lo, k_hi)
    const int q_last = min(q0 + FA_BQ, S) - 1;
    int k_lo = vf, k_hi = T_;
    if (causal) k_hi = min(k_hi, q_last + 1);
    if (window >= 0) k_lo = max(k_lo, q0 - window + 1);

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
            if (causal) ok = ok && j <= i;
            if (window >= 0) ok = ok && i - j < window;
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

// the key tiles [lo, hi) that rows [qa, qa + 64) of a query tile may see
__device__ __forceinline__ void key_tiles(int qa, int S, int T_, int vf, int causal, int window,
                                          int& lo, int& hi)
{
    int k_lo = vf, k_hi = T_;
    if (causal) k_hi = min(k_hi, min(qa + TC_BQ, S));
    if (window >= 0) k_lo = max(k_lo, qa - window + 1);
    lo = k_lo < k_hi ? k_lo / TC_BK : 0;
    hi = k_lo < k_hi ? (k_hi + TC_BK - 1) / TC_BK : 0;
}

// One key tile of one consumer warpgroup: this thread's rows are i0 and
// i0 + 8, its columns of each 8-column block cq and cq + 1.  MASK: the tile
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
                       float cap, float scale)
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
    key_tiles(qa0, S, T_, vf, causal, window, lo0, hi0);
    key_tiles(qa1, S, T_, vf, causal, window, lo1, hi1);
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
                const bool inner = j0 + TC_BK <= T_ && j0 >= vf &&
                                   (!causal || j0 + TC_BK - 1 <= qa) &&
                                   (window < 0 || qa + TC_BQ - 1 - j0 < window);
                if (inner)
                    tc_tile<HDP, false>(O, m0, m1, l0, l1, qdesc, kdesc, vdesc, j0, i0, cq, T_,
                                        vf, causal, window, cap_l2, sc);
                else
                    tc_tile<HDP, true>(O, m0, m1, l0, l1, qdesc, kdesc, vdesc, j0, i0, cq, T_,
                                       vf, causal, window, cap_l2, sc);
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
                      const long long* st, int causal, int window, float cap, float scale,
                      cudaStream_t stream)
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
        st[10], st[11], causal, window, cap, scale);
    return (int)cudaGetLastError();
}

// The 4-D map (hd, rows, heads, B) of a bf16 tensor [B][heads][rows][hd]
// with element strides (sb, sh, sr) and a contiguous hd axis; boxes of
// Tc<HDP>::BOXC columns by 64 rows.  Returns 0, or an error code to raise.
template <int HDP>
static int tile_map(CUtensorMap* map, const void* ptr, int B, int heads, int rows, int hd,
                    long long sb, long long sh, long long sr)
{
    using C = Tc<HDP>;
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)rows, (cuuint64_t)heads,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)sr * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {(cuuint32_t)C::BOXC, (cuuint32_t)TC_BK, 1, 1};
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
                       const long long* st, int causal, int window, float cap, float scale,
                       cudaStream_t stream)
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
                                                  st[10], st[11], causal, window, cap, scale);
    return (int)cudaGetLastError();
}

// hd rounded up to one of the five compiled widths
template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
                    const void* valid_from, int B, int H, int KV, int S, int T_, int hd,
                    const long long* st, int causal, int window, float cap, float scale,
                    cudaStream_t stream)
{
#define FA_CASE(W)                                                                          \
    if (hd <= W) {                                                                          \
        if constexpr (std::is_same<T, float>::value)                                        \
            return launch_f32<W>(q, k, v, o, lse, valid_from, B, H, KV, S, T_, hd, st, causal,   \
                                 window, cap, scale, stream);                               \
        else                                                                                \
            return launch_bf16<W>(q, k, v, o, lse, valid_from, B, H, KV, S, T_, hd, st, causal,  \
                                  window, cap, scale, stream);                              \
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
// none.  S >= 1, H % KV == 0, hd a multiple of 8 in [8, 256]; for
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
                                      int causal, int window, float cap, float scale,
                                      void* stream)
{
    if (B < 1 || S < 1 || T < 0 || KV < 1 || H % KV || hd < 8 || hd > 256 || hd % 8)
        return (int)cudaErrorInvalidValue;
    const long long st[12] = {qsb, qsh, qss, ksb, ksh, kst, vsb, vsh, vst, osb, osh, oss};
    if (dtype == 0)
        return dispatch<float>(q, k, v, o, (float*)lse, valid_from, B, H, KV, S, T, hd, st, causal,
                               window, cap, scale, (cudaStream_t)stream);
    if (dtype == 1) {
        for (int i = 0; i < 12; ++i)
            if (st[i] % 8) return (int)cudaErrorMisalignedAddress;
        if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
            return (int)cudaErrorMisalignedAddress;
        return dispatch<__nv_bfloat16>(q, k, v, o, (float*)lse, valid_from, B, H, KV, S, T, hd, st,
                                       causal, window, cap, scale, (cudaStream_t)stream);
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
// i of query head h (KV head h / G) and key j, with the forward's scores
//   x_ij = q_i . k_j * scale,  s_ij = softcap(x_ij)  (cap * tanh(x / cap)),
// the row's log-sum-exp L_i (K7's lse output) and D_i = dO_i . O_i:
//   P_ij  = exp(s_ij - L_i) over the valid keys (K7's mask), else 0
//   dV_j  = sum_i round(P_ij) dO_i         (P rounded to V's type, as K7's P.V)
//   dS_ij = P_ij (dO_i . v_j - D_i) * (1 - tanh^2(x_ij / cap)) * scale
//   dQ_i  = sum_j dS_ij k_j,   dK_j = sum_i dS_ij q_i
// summed over the G query heads of a KV head for dK and dV.
//
// Three launches on the caller's stream: bwd_dot_kernel, D [B, H, S]
// float32 (one warp per row); a dK/dV pass with one CTA per (key tile, KV
// head, b): the K and V tiles stay in shared memory while the CTA walks the
// G query heads and every query tile that can see the keys (the causal
// diagonal and the window cut the walk), so a KV head's dK and dV are
// summed inside the CTA; a dQ pass with one CTA per (query tile, head, b):
// Q and dO stay in shared memory while it walks the key tiles the rows can
// see.  Each output element is summed by one thread (or one warp's
// fragment) in a fixed order: no atomics, so two runs on the same inputs
// give the same bits.  The scores and dP are recomputed in both passes
// (14 hd operations per valid pair against the 10 hd of the function).
//
// What bounds it on the H100: the five products, 10 hd operations per valid
// pair (2.5 x the forward's 4 hd), against 989 TFLOP/s of bf16 tensor
// cores; the tensors cross device memory once each.  Two bodies:
//   bfloat16 (training at the model's dtype) — bwd_*_tc_kernel below: the
//   products on the tensor cores through WMMA (m16n16k16, float32 sums),
//   every tile staged in shared memory, 8 warps; a first tensor-core design
//   (no TMA, no wgmma, no overlap of loads and products).
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
                                          int vf, int hd, int causal, int window, float cap,
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
    const int i = i0 + r;
    const float L = lse_s[r], Di = d_s[r];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
        const int c = c0 + 8 * n, j = j0 + c;
        bool ok = i < S && j < T_ && j >= vf;
        if (causal) ok = ok && j <= i;
        if (window >= 0) ok = ok && i - j < window;
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
                float* __restrict__ dk, float* __restrict__ dv,
                const int* __restrict__ valid_from, int G, int S, int T_, int hd,
                long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
                long long kst, int causal, int window, float cap, float scale)
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
    const int vf = valid_from != nullptr ? max(valid_from[b], 0) : 0;
    const float* kb = k + b * ksb + kvh * ksh;
    const float* vb = v + b * ksb + kvh * ksh;
    bw_tile(ks, kb, j0, T_, hd, kst, BW_BK);
    bw_tile(vs, vb, j0, T_, hd, kst, BW_BK);

    // the query rows that may see keys [j0, j0 + BW_BK): [i_lo, i_hi)
    int i_lo = causal ? j0 : 0, i_hi = S;
    if (window >= 0) i_hi = min(i_hi, j0 + BW_BK - 1 + window);
    i_lo = max(i_lo, vf);

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
            bw_scores(qs, dos, ks, vs, lse_s, d_s, ps, dss, i0, j0, S, T_, vf, hd, causal,
                         window, cap, scale);
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
              float* __restrict__ dq,
              const int* __restrict__ valid_from, int G, int S, int T_, int hd, long long qsb,
              long long qsh, long long qss, long long ksb, long long ksh, long long kst,
              int causal, int window, float cap, float scale)
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
    const int vf = valid_from != nullptr ? max(valid_from[b], 0) : 0;
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
    int j_lo = vf, j_hi = T_;
    if (causal) j_hi = min(j_hi, i_last + 1);
    if (window >= 0) j_lo = max(j_lo, i0 - window + 1);

    const int r = threadIdx.x >> 3, e0 = threadIdx.x & 7;  // sum phase: row r, columns e0 + 8jj
    float adq[HDMAX / 8];
#pragma unroll
    for (int jj = 0; jj < HDMAX / 8; ++jj) adq[jj] = 0.f;

    for (int j0 = (max(j_lo, 0) / BW_BK) * BW_BK; j0 < j_hi; j0 += BW_BK) {
        __syncthreads();  // the previous tile's readers are done (and Q, dO landed)
        bw_tile(ks, kb, j0, T_, hd, kst, BW_BK);
        bw_tile(vs, vb, j0, T_, hd, kst, BW_BK);
        __syncthreads();
        bw_scores(qs, dos, ks, vs, lse_s, d_s, nullptr, dss, i0, j0, S, T_, vf, hd, causal,
                     window, cap, scale);
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
// bfloat16: the products on the tensor cores (WMMA, m16n16k16, float32 sums)
//
// The same two passes, with every tile staged in shared memory: bf16 Q, dO,
// K and V tiles (rows of HDP = hd rounded up to 16, zero-filled past hd and
// past S or T, padded by 8 elements against bank conflicts), float32 score
// and dP tiles out of the products, and the elementwise step writing P and
// dS back as bf16 tiles for the next products (P rounded to V's type, as
// K7 rounds it; dS rounded too, the price of the tensor cores).  8 warps.
//   bwd_dkdv_tc_kernel: 32 keys a CTA; per 64-row query tile S^T and dP^T
//     (one 16 x 16 tile a warp), then dV += P^T dO and dK += dS^T Q, each
//     warp holding up to 4 + 4 accumulator tiles of the 32 x HDP outputs in
//     registers across the G heads and query tiles.
//   bwd_dq_tc_kernel: 64 query rows a CTA; per 64-key tile S and dP (two
//     tiles a warp), then dQ += dS K, up to 8 accumulator tiles a warp.
// Each output element is summed by one warp in a fixed order: no atomics.
// ---------------------------------------------------------------------------

#define TB_BK 32
#define TB_BQ 64
#define TB_WARPS 8

template <int HDP> struct Tb {
    static constexpr int LDH = HDP + 8;    // bf16 row stride of Q, dO, K, V tiles
    static constexpr int LDS = 64 + 4;     // float32 row stride of score tiles
    static constexpr int LDP = 64 + 8;     // bf16 row stride of P, dS tiles
};

// rows [0, rows) of a bf16 tile of HDP columns from src (row stride rs,
// hd valid columns, rows r0 + r < n_valid), 16 bytes at a time
__device__ __forceinline__ void tb_tile(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                        int r0, int n_valid, int hd, int hdp, long long rs,
                                        int rows)
{
    const int chunks = hdp / 8;
    for (int idx = threadIdx.x; idx < rows * chunks; idx += TB_WARPS * 32) {
        const int r = idx / chunks, c = (idx - r * chunks) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + r < n_valid && c < hd)
            v = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rs + c);
        *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
    }
}

// the elementwise step on a [rows][64] float32 pair (S, dP) whose element
// (a, b) is query qi(a, b), key kj(a, b): P (rounded) to pb, dS (scale and
// the cap's derivative folded in) to dsb; lse and D by query row
template <bool KEY_ROWS>
__device__ __forceinline__ void tb_softmax_grad(const float* ss, const float* dps, int lds,
                                                __nv_bfloat16* pb, __nv_bfloat16* dsb,
                                                int ldp, int rows, const float* lse_s,
                                                const float* d_s, int i0, int j0, int S,
                                                int T_, int vf, int causal, int window,
                                                float cap, float scale)
{
    for (int e = threadIdx.x; e < rows * 64; e += TB_WARPS * 32) {
        const int a = e >> 6, b = e & 63;
        const int qr = KEY_ROWS ? b : a;  // the query row within its tile
        const int i = i0 + qr, j = j0 + (KEY_ROWS ? a : b);
        bool ok = i < S && j < T_ && j >= vf;
        if (causal) ok = ok && j <= i;
        if (window >= 0) ok = ok && i - j < window;
        const float x = ss[a * lds + b] * scale;
        float sv = x, dcap = 1.f;
        if (cap > 0.f) {
            const float t = tanhf(x / cap);
            sv = cap * t;
            dcap = 1.f - t * t;
        }
        const float p = ok ? expf(sv - lse_s[qr]) : 0.f;
        if (pb != nullptr) pb[a * ldp + b] = __float2bfloat16_rn(p);
        dsb[a * ldp + b] = __float2bfloat16_rn(p * (dps[a * lds + b] - d_s[qr]) * dcap * scale);
    }
}

template <int HDP>
__global__ void __launch_bounds__(TB_WARPS * 32)
bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dsum,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                   const int* __restrict__ valid_from, int G, int S, int T_, int hd,
                   long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
                   long long kst, int causal, int window, float cap, float scale)
{
    using C = Tb<HDP>;
    namespace w = nvcuda::wmma;
    extern __shared__ __align__(128) unsigned char tb_smem[];
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(tb_smem);  // [TB_BK][LDH]
    __nv_bfloat16* vs = ks + TB_BK * C::LDH;                         // [TB_BK][LDH]
    __nv_bfloat16* qs = vs + TB_BK * C::LDH;                         // [TB_BQ][LDH]
    __nv_bfloat16* dos = qs + TB_BQ * C::LDH;                        // [TB_BQ][LDH]
    float* ss = reinterpret_cast<float*>(dos + TB_BQ * C::LDH);      // [TB_BK][LDS]
    float* dps = ss + TB_BK * C::LDS;                                // [TB_BK][LDS]
    __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(dps + TB_BK * C::LDS);  // [TB_BK][LDP]
    __nv_bfloat16* dsb = pb + TB_BK * C::LDP;                        // [TB_BK][LDP]
    float* lse_s = reinterpret_cast<float*>(dsb + TB_BK * C::LDP);   // [TB_BQ]
    float* d_s = lse_s + TB_BQ;                                      // [TB_BQ]

    const int kvh = blockIdx.y, b = blockIdx.z, j0 = blockIdx.x * TB_BK;
    const int H = gridDim.y * G;
    const int vf = valid_from != nullptr ? max(valid_from[b], 0) : 0;
    const int warp = threadIdx.x >> 5;
    tb_tile(ks, C::LDH, k + b * ksb + kvh * ksh, j0, T_, hd, HDP, kst, TB_BK);
    tb_tile(vs, C::LDH, v + b * ksb + kvh * ksh, j0, T_, hd, HDP, kst, TB_BK);

    int i_lo = causal ? j0 : 0, i_hi = S;
    if (window >= 0) i_hi = min(i_hi, j0 + TB_BK - 1 + window);
    i_lo = max(i_lo, vf);

    // output tiles of [TB_BK][HDP]: t = warp + 8 n
    constexpr int NT = (TB_BK / 16) * (HDP / 16);
    constexpr int NTW = (NT + TB_WARPS - 1) / TB_WARPS;
    w::fragment<w::accumulator, 16, 16, 16, float> adv[NTW], adk[NTW];
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
        w::fill_fragment(adv[n], 0.f);
        w::fill_fragment(adk[n], 0.f);
    }
    const int skb = warp >> 2, sqb = warp & 3;  // this warp's S^T tile

    for (int g = 0; g < G; ++g) {
        const int h = kvh * G + g;
        const __nv_bfloat16* qb = q + b * qsb + h * qsh;
        const __nv_bfloat16* db = dout + b * qsb + h * qsh;
        const float* lrow = lse + ((long long)b * H + h) * S;
        const float* drow = dsum + ((long long)b * H + h) * S;
        for (int i0 = (i_lo / TB_BQ) * TB_BQ; i0 < i_hi; i0 += TB_BQ) {
            __syncthreads();  // the previous tile's readers are done
            tb_tile(qs, C::LDH, qb, i0, S, hd, HDP, qss, TB_BQ);
            tb_tile(dos, C::LDH, db, i0, S, hd, HDP, qss, TB_BQ);
            if (threadIdx.x < TB_BQ) {
                const int i = i0 + threadIdx.x;
                lse_s[threadIdx.x] = i < S ? lrow[i] : INFINITY;
                d_s[threadIdx.x] = i < S ? drow[i] : 0.f;
            }
            __syncthreads();
            {   // S^T = K Q^T and dP^T = V dO^T, one 16 x 16 tile each
                w::fragment<w::accumulator, 16, 16, 16, float> sacc, pacc;
                w::fill_fragment(sacc, 0.f);
                w::fill_fragment(pacc, 0.f);
                w::fragment<w::matrix_a, 16, 16, 16, __nv_bfloat16, w::row_major> fa;
                w::fragment<w::matrix_b, 16, 16, 16, __nv_bfloat16, w::col_major> fb;
#pragma unroll 4
                for (int kk = 0; kk < HDP / 16; ++kk) {
                    w::load_matrix_sync(fa, ks + skb * 16 * C::LDH + kk * 16, C::LDH);
                    w::load_matrix_sync(fb, qs + sqb * 16 * C::LDH + kk * 16, C::LDH);
                    w::mma_sync(sacc, fa, fb, sacc);
                    w::load_matrix_sync(fa, vs + skb * 16 * C::LDH + kk * 16, C::LDH);
                    w::load_matrix_sync(fb, dos + sqb * 16 * C::LDH + kk * 16, C::LDH);
                    w::mma_sync(pacc, fa, fb, pacc);
                }
                w::store_matrix_sync(ss + skb * 16 * C::LDS + sqb * 16, sacc, C::LDS,
                                     w::mem_row_major);
                w::store_matrix_sync(dps + skb * 16 * C::LDS + sqb * 16, pacc, C::LDS,
                                     w::mem_row_major);
            }
            __syncthreads();
            tb_softmax_grad<true>(ss, dps, C::LDS, pb, dsb, C::LDP, TB_BK, lse_s, d_s, i0, j0,
                                  S, T_, vf, causal, window, cap, scale);
            __syncthreads();
            // dV += P^T dO, dK += dS^T Q over the tile's 64 query rows
#pragma unroll
            for (int n = 0; n < NTW; ++n) {
                const int t = warp + TB_WARPS * n;
                if (t >= NT) break;
                const int kb = t / (HDP / 16), dbk = t - kb * (HDP / 16);
                w::fragment<w::matrix_a, 16, 16, 16, __nv_bfloat16, w::row_major> fa;
                w::fragment<w::matrix_b, 16, 16, 16, __nv_bfloat16, w::row_major> fb;
#pragma unroll
                for (int qk = 0; qk < TB_BQ / 16; ++qk) {
                    w::load_matrix_sync(fa, pb + kb * 16 * C::LDP + qk * 16, C::LDP);
                    w::load_matrix_sync(fb, dos + qk * 16 * C::LDH + dbk * 16, C::LDH);
                    w::mma_sync(adv[n], fa, fb, adv[n]);
                    w::load_matrix_sync(fa, dsb + kb * 16 * C::LDP + qk * 16, C::LDP);
                    w::load_matrix_sync(fb, qs + qk * 16 * C::LDH + dbk * 16, C::LDH);
                    w::mma_sync(adk[n], fa, fb, adk[n]);
                }
            }
        }
    }
    // the accumulators through shared memory (float32 [TB_BK][HDP + 4] each,
    // over the Q and dO tiles) to dK and dV in bf16
    __syncthreads();
    constexpr int LDO = HDP + 4;
    float* ok_ = reinterpret_cast<float*>(qs);
    float* ov_ = ok_ + TB_BK * LDO;
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
        const int t = warp + TB_WARPS * n;
        if (t >= NT) break;
        const int kb = t / (HDP / 16), dbk = t - kb * (HDP / 16);
        w::store_matrix_sync(ok_ + kb * 16 * LDO + dbk * 16, adk[n], LDO, w::mem_row_major);
        w::store_matrix_sync(ov_ + kb * 16 * LDO + dbk * 16, adv[n], LDO, w::mem_row_major);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < TB_BK * hd; idx += TB_WARPS * 32) {
        const int c = idx / hd, d = idx - c * hd, j = j0 + c;
        if (j >= T_) continue;
        dk[b * ksb + kvh * ksh + j * kst + d] = __float2bfloat16_rn(ok_[c * LDO + d]);
        dv[b * ksb + kvh * ksh + j * kst + d] = __float2bfloat16_rn(ov_[c * LDO + d]);
    }
}

template <int HDP>
__global__ void __launch_bounds__(TB_WARPS * 32)
bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dsum,
                 __nv_bfloat16* __restrict__ dq, const int* __restrict__ valid_from, int G,
                 int S, int T_, int hd, long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kst, int causal, int window,
                 float cap, float scale)
{
    using C = Tb<HDP>;
    namespace w = nvcuda::wmma;
    extern __shared__ __align__(128) unsigned char tb_smem[];
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tb_smem);  // [TB_BQ][LDH]
    __nv_bfloat16* dos = qs + TB_BQ * C::LDH;                        // [TB_BQ][LDH]
    __nv_bfloat16* ks = dos + TB_BQ * C::LDH;                        // [64][LDH]
    __nv_bfloat16* vs = ks + 64 * C::LDH;                            // [64][LDH]
    float* ss = reinterpret_cast<float*>(vs + 64 * C::LDH);          // [TB_BQ][LDS]
    float* dps = ss + TB_BQ * C::LDS;                                // [TB_BQ][LDS]
    __nv_bfloat16* dsb = reinterpret_cast<__nv_bfloat16*>(dps + TB_BQ * C::LDS);  // [TB_BQ][LDP]
    float* lse_s = reinterpret_cast<float*>(dsb + TB_BQ * C::LDP);
    float* d_s = lse_s + TB_BQ;

    const int h = blockIdx.y, b = blockIdx.z;
    const int i0 = (gridDim.x - 1 - blockIdx.x) * TB_BQ;  // the longest rows first
    const int H = gridDim.y;
    const int vf = valid_from != nullptr ? max(valid_from[b], 0) : 0;
    const int warp = threadIdx.x >> 5;
    const __nv_bfloat16* kb_ = k + b * ksb + (h / G) * ksh;
    const __nv_bfloat16* vb_ = v + b * ksb + (h / G) * ksh;
    tb_tile(qs, C::LDH, q + b * qsb + h * qsh, i0, S, hd, HDP, qss, TB_BQ);
    tb_tile(dos, C::LDH, dout + b * qsb + h * qsh, i0, S, hd, HDP, qss, TB_BQ);
    if (threadIdx.x < TB_BQ) {
        const int i = i0 + threadIdx.x;
        lse_s[threadIdx.x] = i < S ? lse[((long long)b * H + h) * S + i] : INFINITY;
        d_s[threadIdx.x] = i < S ? dsum[((long long)b * H + h) * S + i] : 0.f;
    }
    const int i_last = min(i0 + TB_BQ, S) - 1;
    int j_lo = vf, j_hi = T_;
    if (causal) j_hi = min(j_hi, i_last + 1);
    if (window >= 0) j_lo = max(j_lo, i0 - window + 1);

    constexpr int NT = (TB_BQ / 16) * (HDP / 16);
    constexpr int NTW = (NT + TB_WARPS - 1) / TB_WARPS;
    w::fragment<w::accumulator, 16, 16, 16, float> adq[NTW];
#pragma unroll
    for (int n = 0; n < NTW; ++n) w::fill_fragment(adq[n], 0.f);

    for (int j0 = (max(j_lo, 0) / 64) * 64; j0 < j_hi; j0 += 64) {
        __syncthreads();  // the previous tile's readers are done (and Q, dO landed)
        tb_tile(ks, C::LDH, kb_, j0, T_, hd, HDP, kst, 64);
        tb_tile(vs, C::LDH, vb_, j0, T_, hd, HDP, kst, 64);
        __syncthreads();
#pragma unroll
        for (int n = 0; n < 2; ++n) {  // S = Q K^T and dP = dO V^T: tiles warp, warp + 8
            const int t = warp + TB_WARPS * n, qb = t >> 2, kb = t & 3;
            w::fragment<w::accumulator, 16, 16, 16, float> sacc, pacc;
            w::fill_fragment(sacc, 0.f);
            w::fill_fragment(pacc, 0.f);
            w::fragment<w::matrix_a, 16, 16, 16, __nv_bfloat16, w::row_major> fa;
            w::fragment<w::matrix_b, 16, 16, 16, __nv_bfloat16, w::col_major> fb;
#pragma unroll 4
            for (int kk = 0; kk < HDP / 16; ++kk) {
                w::load_matrix_sync(fa, qs + qb * 16 * C::LDH + kk * 16, C::LDH);
                w::load_matrix_sync(fb, ks + kb * 16 * C::LDH + kk * 16, C::LDH);
                w::mma_sync(sacc, fa, fb, sacc);
                w::load_matrix_sync(fa, dos + qb * 16 * C::LDH + kk * 16, C::LDH);
                w::load_matrix_sync(fb, vs + kb * 16 * C::LDH + kk * 16, C::LDH);
                w::mma_sync(pacc, fa, fb, pacc);
            }
            w::store_matrix_sync(ss + qb * 16 * C::LDS + kb * 16, sacc, C::LDS,
                                 w::mem_row_major);
            w::store_matrix_sync(dps + qb * 16 * C::LDS + kb * 16, pacc, C::LDS,
                                 w::mem_row_major);
        }
        __syncthreads();
        tb_softmax_grad<false>(ss, dps, C::LDS, nullptr, dsb, C::LDP, TB_BQ, lse_s, d_s, i0,
                               j0, S, T_, vf, causal, window, cap, scale);
        __syncthreads();
#pragma unroll
        for (int n = 0; n < NTW; ++n) {  // dQ += dS K
            const int t = warp + TB_WARPS * n;
            if (t >= NT) break;
            const int qb = t / (HDP / 16), dbk = t - qb * (HDP / 16);
            w::fragment<w::matrix_a, 16, 16, 16, __nv_bfloat16, w::row_major> fa;
            w::fragment<w::matrix_b, 16, 16, 16, __nv_bfloat16, w::row_major> fb;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                w::load_matrix_sync(fa, dsb + qb * 16 * C::LDP + kk * 16, C::LDP);
                w::load_matrix_sync(fb, ks + kk * 16 * C::LDH + dbk * 16, C::LDH);
                w::mma_sync(adq[n], fa, fb, adq[n]);
            }
        }
    }
    __syncthreads();
    constexpr int LDO = HDP + 4;
    float* oq = reinterpret_cast<float*>(ks);  // [TB_BQ][LDO] over the K and V tiles
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
        const int t = warp + TB_WARPS * n;
        if (t >= NT) break;
        const int qb = t / (HDP / 16), dbk = t - qb * (HDP / 16);
        w::store_matrix_sync(oq + qb * 16 * LDO + dbk * 16, adq[n], LDO, w::mem_row_major);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < TB_BQ * hd; idx += TB_WARPS * 32) {
        const int r = idx / hd, d = idx - r * hd, i = i0 + r;
        if (i < S) dq[b * qsb + h * qsh + i * qss + d] = __float2bfloat16_rn(oq[r * LDO + d]);
    }
}

template <int HDP>
static size_t tb_dkdv_smem()
{
    using C = Tb<HDP>;
    return 2 * ((size_t)2 * TB_BK * C::LDH + 2 * TB_BQ * C::LDH) +
           4 * (size_t)2 * TB_BK * C::LDS + 2 * (size_t)2 * TB_BK * C::LDP + 4 * 2 * TB_BQ;
}

template <int HDP>
static size_t tb_dq_smem()
{
    using C = Tb<HDP>;
    return 2 * ((size_t)2 * TB_BQ * C::LDH + 2 * 64 * C::LDH) + 4 * (size_t)2 * TB_BQ * C::LDS +
           2 * (size_t)TB_BQ * C::LDP + 4 * 2 * TB_BQ;
}

template <typename T, int HDMAX>
static int launch_bwd(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* dsum, void* dq, void* dk,
                      void* dv, const void* valid_from, int B, int H, int KV, int S, int T_,
                      int hd, const long long* st, int causal, int window, float cap,
                      float scale, cudaStream_t stream)
{
    const int G = H / KV;
    const long long rows = (long long)B * H * S;
    bwd_dot_kernel<T><<<(unsigned)((rows + BW_THREADS / 32 - 1) / (BW_THREADS / 32)), BW_THREADS,
                        0, stream>>>((const T*)o, (const T*)dout, dsum, H, S, hd, st[0], st[1],
                                     st[2], rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if constexpr (std::is_same<T, float>::value) {
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
        const dim3 gkv((T_ + BW_BK - 1) / BW_BK, KV, B);
        kdkdv<<<gkv, BW_THREADS, smem, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, (T*)dk, (T*)dv,
            (const int*)valid_from, G, S, T_, hd, st[0], st[1], st[2], st[3], st[4], st[5],
            causal, window, cap, scale);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        const dim3 gq((S + BW_BQ - 1) / BW_BQ, H, B);
        kdq<<<gq, BW_THREADS, smem, stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, (T*)dq,
            (const int*)valid_from, G, S, T_, hd, st[0], st[1], st[2], st[3], st[4], st[5],
            causal, window, cap, scale);
    } else {
        // bf16: the tensor-core body at HDP = HDMAX (hd rounded up to a compiled width)
        const auto kdkdv = bwd_dkdv_tc_kernel<HDMAX>;
        const auto kdq = bwd_dq_tc_kernel<HDMAX>;
        static bool raised = false;
        if (!raised) {
            err = cudaFuncSetAttribute(kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)tb_dkdv_smem<HDMAX>());
            if (err == cudaSuccess)
                err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)tb_dq_smem<HDMAX>());
            if (err != cudaSuccess) return (int)err;
            raised = true;
        }
        const dim3 gkv((T_ + TB_BK - 1) / TB_BK, KV, B);
        kdkdv<<<gkv, TB_WARPS * 32, tb_dkdv_smem<HDMAX>(), stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, (T*)dk, (T*)dv,
            (const int*)valid_from, G, S, T_, hd, st[0], st[1], st[2], st[3], st[4], st[5],
            causal, window, cap, scale);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        const dim3 gq((S + TB_BQ - 1) / TB_BQ, H, B);
        kdq<<<gq, TB_WARPS * 32, tb_dq_smem<HDMAX>(), stream>>>(
            (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, (T*)dq,
            (const int*)valid_from, G, S, T_, hd, st[0], st[1], st[2], st[3], st[4], st[5],
            causal, window, cap, scale);
    }
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* dsum, void* dq, void* dk,
                        void* dv, const void* valid_from, int B, int H, int KV, int S, int T_,
                        int hd, const long long* st, int causal, int window, float cap,
                        float scale, cudaStream_t stream)
{
#define BW_CASE(W)                                                                          \
    if (hd <= W)                                                                            \
        return launch_bwd<T, W>(q, k, v, o, dout, lse, dsum, dq, dk, dv, valid_from, B, H,  \
                                KV, S, T_, hd, st, causal, window, cap, scale, stream);
    BW_CASE(16) BW_CASE(32) BW_CASE(64) BW_CASE(128) BW_CASE(256)
#undef BW_CASE
    return (int)cudaErrorInvalidValue;
}

// q, o, dout and dq [B, H, S, hd] by strides (qsb, qsh, qss); k, v, dk and
// dv [B, KV, T, hd] by strides (ksb, ksh, kst); the hd axis contiguous.
// lse [B, H, S] float32 from K7's forward on the same q, k, v; dsum [B, H,
// S] float32 scratch (D).  dtype 0 = float32, 1 = bfloat16 (every tensor
// but lse and dsum).  valid_from, window, cap and scale as the forward's.
// Launches three kernels on `stream` and returns the first error of a
// launch (0 on success).
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dsum, void* dq, void* dk, void* dv, const void* valid_from,
    int dtype, int B, int H, int KV, int S, int T, int hd, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kst, int causal, int window,
    float cap, float scale, void* stream)
{
    if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV || hd < 8 || hd > 256 || hd % 8)
        return (int)cudaErrorInvalidValue;
    const long long st[6] = {qsb, qsh, qss, ksb, ksh, kst};
    if (dtype == 0)
        return dispatch_bwd<float>(q, k, v, o, dout, (const float*)lse, (float*)dsum, dq, dk,
                                   dv, valid_from, B, H, KV, S, T, hd, st, causal, window, cap,
                                   scale, (cudaStream_t)stream);
    if (dtype == 1) {
        // the tensor-core body reads rows 16 bytes at a time
        for (int i = 0; i < 6; ++i)
            if (st[i] % 8) return (int)cudaErrorMisalignedAddress;
        if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)dout) % 16)
            return (int)cudaErrorMisalignedAddress;
        return dispatch_bwd<__nv_bfloat16>(q, k, v, o, dout, (const float*)lse, (float*)dsum,
                                           dq, dk, dv, valid_from, B, H, KV, S, T, hd, st,
                                           causal, window, cap, scale, (cudaStream_t)stream);
    }
    return (int)cudaErrorInvalidValue;
}
