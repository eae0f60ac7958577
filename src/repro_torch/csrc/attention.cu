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
// element types float32 and bfloat16.  Ragged S and T are masked in the
// kernel, with no padded copies; strides let one kernel read the [B, H, S,
// hd] layout of flash_attention and the [B, S, H, hd] layout of the model.
//
// What bounds it on the H100: the two matrix products, 4 * hd operations
// per valid (query, key) pair, against 989 TFLOP/s of bf16 tensor cores;
// q, k, v and o cross device memory once each (3.35 TB/s), far less at
// any prefill length that matters.
//
// What the design does about it, by element type:
//   bfloat16 (the model's prefill) — both products on the tensor cores
//   through mma.sync m16n8k16 with float32 accumulators (see
//   flash_fwd_tc_kernel below): one CTA of 4 warps per (b, h, 64-query
//   tile), 64-key tiles, scores and the online softmax kept in registers.
//   No wgmma, no TMA, no pipelining of the K/V loads yet, and the G query
//   heads of a KV head each read its K/V tiles (from L2): a later design
//   serves the G heads from one CTA behind a ring of TMA stages.
//   float32 (the reduced configs and the parity cases) — the exact
//   version on the FMA pipes (flash_fwd_kernel): one CTA of 256 threads per
//   (b, h, 64-query tile), K and V tiles of 32 keys staged in shared memory
//   as float32 (rows padded to an odd stride, so the 32 lanes of a warp hit
//   distinct banks), four threads per query row, P in shared memory between
//   the products; bound by shared-memory loads, about one per FMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
                 const int* __restrict__ valid_from, int G, int S, int T_, int hd,
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
    float* orow = ob + i * oss;
#pragma unroll
    for (int jj = 0; jj < HDMAX / 4; ++jj) {
        const int d = 4 * jj + sub;
        if (d < hd) orow[d] = l > 0.f ? acc[jj] / fmaxf(l, 1e-37f) : 0.f;
    }
}

// ---------------------------------------------------------------------------
// bfloat16: both products on the tensor cores (mma.sync m16n8k16, float32
// accumulators).  One CTA of 4 warps per (b, h, 64-query tile); each warp
// owns 16 query rows.  Q, K and V tiles of 64 rows sit in shared memory as
// bfloat16, rows padded by 16 bytes (the 8 row groups of a fragment load
// hit distinct banks), filled by 16-byte loads; columns past hd read as 0.
// S = Q.K^T stays in the accumulator fragments, where the mask, scale, cap
// and the online softmax are applied; the rounded p fragments are repacked
// in registers as the A operand of P.V (the C layout of two 8-key tiles is
// the A layout of one 16-key step).  The row sum is kept per thread and
// reduced over the row's four lanes at the end.
// ---------------------------------------------------------------------------

#define TC_BQ 64
#define TC_BK 64
#define TC_THREADS 128

static size_t tc_smem_bytes(int hdp)
{
    return sizeof(__nv_bfloat16) * 3 * (size_t)TC_BQ * (hdp + 8);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi)
{
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pair_u32(const __nv_bfloat16* p)
{
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_u16(__nv_bfloat16 lo, __nv_bfloat16 hi)
{
    return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// rows [r0, r0 + 64) x columns [0, HDP) of a [rows, hd] bf16 matrix with
// row stride `rs` into shared memory; rows >= n_rows and columns >= hd read 0
template <int HDP>
__device__ __forceinline__ void tc_load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                             long long rs, int r0, int n_rows, int hd)
{
    constexpr int LDS = HDP + 8, CH = HDP / 8;
    for (int idx = threadIdx.x; idx < TC_BQ * CH; idx += TC_THREADS) {
        const int r = idx / CH, c = (idx - r * CH) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + r < n_rows && c < hd)
            val = *reinterpret_cast<const uint4*>(src + (r0 + r) * rs + c);
        *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
    }
}

template <int HDP>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    const int* __restrict__ valid_from, int G, int S, int T_, int hd,
                    long long qsb, long long qsh, long long qss,
                    long long ksb, long long ksh, long long kst,
                    long long vsb, long long vsh, long long vst,
                    long long osb, long long osh, long long oss,
                    int causal, int window, float cap, float scale)
{
    constexpr int LDS = HDP + 8;
    extern __shared__ __align__(16) unsigned char tc_smem[];
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
    __nv_bfloat16* ks = qs + TC_BQ * LDS;
    __nv_bfloat16* vs = ks + TC_BK * LDS;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int h = blockIdx.y, b = blockIdx.z;
    const int q0 = blockIdx.x * TC_BQ;
    const int vf = valid_from != nullptr ? max(valid_from[b], 0) : 0;
    const __nv_bfloat16* kb = k + b * ksb + (h / G) * ksh;
    const __nv_bfloat16* vb = v + b * vsb + (h / G) * vsh;

    tc_load_tile<HDP>(qs, q + b * qsb + h * qsh, qss, q0, S, hd);

    const int q_last = min(q0 + TC_BQ, S) - 1;
    int k_lo = vf, k_hi = T_;
    if (causal) k_hi = min(k_hi, q_last + 1);
    if (window >= 0) k_lo = max(k_lo, q0 - window + 1);

    // this thread's rows: i0 = row g of the warp's 16, i1 = row g + 8
    const int wr = warp * 16;
    const int i0 = q0 + wr + g, i1 = i0 + 8;
    float m0 = FA_NEG_INF, m1 = FA_NEG_INF, l0 = 0.f, l1 = 0.f;
    float acc[HDP / 8][4];
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    for (int k0 = (k_lo / TC_BK) * TC_BK; k0 < k_hi; k0 += TC_BK) {
        __syncthreads();  // the previous tile's readers are done (and Q is in)
        tc_load_tile<HDP>(ks, kb, kst, k0, T_, hd);
        tc_load_tile<HDP>(vs, vb, vst, k0, T_, hd);
        __syncthreads();

        float sc[TC_BK / 8][4];
#pragma unroll
        for (int n = 0; n < TC_BK / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
            const __nv_bfloat16* qa = qs + (wr + g) * LDS + kk * 16 + tq * 2;
            const uint32_t a0 = pair_u32(qa), a1 = pair_u32(qa + 8 * LDS);
            const uint32_t a2 = pair_u32(qa + 8), a3 = pair_u32(qa + 8 * LDS + 8);
#pragma unroll
            for (int n = 0; n < TC_BK / 8; ++n) {
                const __nv_bfloat16* kp = ks + (n * 8 + g) * LDS + kk * 16 + tq * 2;
                mma_bf16(sc[n], a0, a1, a2, a3, pair_u32(kp), pair_u32(kp + 8));
            }
        }

        // mask, scale, cap; the running max of rows i0 and i1
        float mx0 = FA_NEG_INF, mx1 = FA_NEG_INF;
        uint32_t valid = 0u;  // bit 4n + e: fragment element sc[n][e] is a valid key
#pragma unroll
        for (int n = 0; n < TC_BK / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = e < 2 ? i0 : i1;
                const int j = k0 + n * 8 + tq * 2 + (e & 1);
                bool ok = i < S && j < T_ && j >= vf;
                if (causal) ok = ok && j <= i;
                if (window >= 0) ok = ok && i - j < window;
                float s = sc[n][e] * scale;
                if (cap > 0.f) s = cap * tanhf(s / cap);
                sc[n][e] = s;
                if (ok) {
                    valid |= 1u << (4 * n + e);
                    if (e < 2) mx0 = fmaxf(mx0, s); else mx1 = fmaxf(mx1, s);
                }
            }
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(FULL_MASK, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(FULL_MASK, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float ps0 = 0.f, ps1 = 0.f;
        uint32_t pa[TC_BK / 8][2];  // rounded p, packed: [n][row g | row g + 8]
#pragma unroll
        for (int n = 0; n < TC_BK / 8; ++n) {
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float mrow = e < 2 ? mn0 : mn1;
                p[e] = (valid >> (4 * n + e)) & 1u
                           ? __bfloat162float(__float2bfloat16_rn(expf(sc[n][e] - mrow)))
                           : 0.f;
            }
            ps0 += p[0] + p[1];
            ps1 += p[2] + p[3];
            pa[n][0] = pack_bf16(p[0], p[1]);
            pa[n][1] = pack_bf16(p[2], p[3]);
        }
        l0 = l0 * al0 + ps0;
        l1 = l1 * al1 + ps1;
#pragma unroll
        for (int n = 0; n < HDP / 8; ++n) {
            acc[n][0] *= al0; acc[n][1] *= al0;
            acc[n][2] *= al1; acc[n][3] *= al1;
        }
        // O += P . V, 16 keys a step
#pragma unroll
        for (int kk = 0; kk < TC_BK / 16; ++kk) {
            const uint32_t a0 = pa[2 * kk][0], a1 = pa[2 * kk][1];
            const uint32_t a2 = pa[2 * kk + 1][0], a3 = pa[2 * kk + 1][1];
            const __nv_bfloat16* vr = vs + (kk * 16 + tq * 2) * LDS + g;
#pragma unroll
            for (int n = 0; n < HDP / 8; ++n) {
                if (n * 8 >= hd) break;
                const __nv_bfloat16* vp = vr + n * 8;
                mma_bf16(acc[n], a0, a1, a2, a3, pack_u16(vp[0], vp[LDS]),
                         pack_u16(vp[8 * LDS], vp[9 * LDS]));
            }
        }
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(FULL_MASK, l0, off);
        l1 += __shfl_xor_sync(FULL_MASK, l1, off);
    }
    __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
        const int d = n * 8 + tq * 2;
        if (d >= hd) break;
        if (i0 < S) {
            const float r0 = l0 > 0.f ? acc[n][0] / fmaxf(l0, 1e-37f) : 0.f;
            const float r1 = l0 > 0.f ? acc[n][1] / fmaxf(l0, 1e-37f) : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(ob + i0 * oss + d) = __floats2bfloat162_rn(r0, r1);
        }
        if (i1 < S) {
            const float r0 = l1 > 0.f ? acc[n][2] / fmaxf(l1, 1e-37f) : 0.f;
            const float r1 = l1 > 0.f ? acc[n][3] / fmaxf(l1, 1e-37f) : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(ob + i1 * oss + d) = __floats2bfloat162_rn(r0, r1);
        }
    }
}

// ---------------------------------------------------------------------------
// One launcher for both bodies
// ---------------------------------------------------------------------------

// The body of each element type at compile-time width HDP: its kernel, its
// query tile and CTA size, and the dynamic shared memory a launch takes.
template <typename T, int HDP> struct Fwd;
template <int HDP> struct Fwd<float, HDP> {
    static constexpr auto kernel = flash_fwd_kernel<HDP>;
    static constexpr int BQ = FA_BQ, THREADS = FA_THREADS;
    static size_t bytes(int hd) { return smem_bytes(hd); }
};
template <int HDP> struct Fwd<__nv_bfloat16, HDP> {
    static constexpr auto kernel = flash_fwd_tc_kernel<HDP>;
    static constexpr int BQ = TC_BQ, THREADS = TC_THREADS;
    static size_t bytes(int) { return tc_smem_bytes(HDP); }
};

template <typename T, int HDP>
static int launch(const void* q, const void* k, const void* v, void* o,
                  const void* valid_from, int B, int H, int KV, int S, int T_, int hd,
                  const long long* st, int causal, int window, float cap, float scale,
                  cudaStream_t stream)
{
    using F = Fwd<T, HDP>;
    const auto kernel = F::kernel;
    const size_t bytes = F::bytes(hd);
    // per instantiation: raise the limit once, to the widest launch (hd = HDP)
    static bool raised = false;
    if (bytes > 48 * 1024 && !raised) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F::bytes(HDP));
        if (err != cudaSuccess) return (int)err;
        raised = true;
    }
    const dim3 grid((S + F::BQ - 1) / F::BQ, H, B);
    kernel<<<grid, F::THREADS, bytes, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, (const int*)valid_from, H / KV, S, T_,
        hd, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
        st[11], causal, window, cap, scale);
    return (int)cudaGetLastError();
}

// hd rounded up to one of the five compiled widths
template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* o,
                    const void* valid_from, int B, int H, int KV, int S, int T_, int hd,
                    const long long* st, int causal, int window, float cap, float scale,
                    cudaStream_t stream)
{
#define FA_CASE(W)                                                                      \
    if (hd <= W)                                                                        \
        return launch<T, W>(q, k, v, o, valid_from, B, H, KV, S, T_, hd, st, causal,    \
                            window, cap, scale, stream);
    FA_CASE(16) FA_CASE(32) FA_CASE(64) FA_CASE(128) FA_CASE(256)
#undef FA_CASE
    return (int)cudaErrorInvalidValue;
}

// q [B, H, S, hd] and o by strides (qsb, qsh, qss) / (osb, osh, oss); k, v
// [B, KV, T, hd] by strides (ksb, ksh, kst) / (vsb, vsh, vst); the hd axis
// is contiguous.  dtype 0 = float32, 1 = bfloat16 (all four tensors).
// valid_from [B] int32 or null (all 0); window < 0 = none; cap <= 0 =
// none.  S >= 1, H % KV == 0, hd a multiple of 8 in [8, 256].  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      const void* valid_from, int dtype, int B, int H,
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
        return dispatch<float>(q, k, v, o, valid_from, B, H, KV, S, T, hd, st, causal,
                               window, cap, scale, (cudaStream_t)stream);
    if (dtype == 1) {
        // the tensor-core path reads 16-byte chunks: 8-element-aligned rows
        for (int i = 0; i < 12; ++i)
            if (st[i] % 8) return (int)cudaErrorMisalignedAddress;
        if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
            return (int)cudaErrorMisalignedAddress;
        return dispatch<__nv_bfloat16>(q, k, v, o, valid_from, B, H, KV, S, T, hd, st,
                                       causal, window, cap, scale, (cudaStream_t)stream);
    }
    return (int)cudaErrorInvalidValue;
}
