// K1 — batched bitset closure, hand-written for Hopper (sm_90a).
// Over K object shards at once (grid.y = shard), as the simulated plans'
// unfused rounds need it.
//
// Replaces: src/repro/kernels/closure.py:closure_pallas (body
// _closure_kernel, _tree_and).  Per candidate b it computes
//   match[n]   = all_w((R[n, w] & C[b, w]) == C[b, w])
//   closure[b] = AND of the matching rows (identity 0xFFFFFFFF)
//   support[b] = number of matching rows
// raw: not masked to the real attributes, not corrected for padding rows.
//
// What bounds it on the H100: integer ALU issue, not memory.  One round
// reads N*W + B*W words and writes B*(W+1), but does about 4*B*N*W word
// operations (the census of benchmarks/roofline.py); at the main path's
// shapes (B = N = 8192, W = 4) that is ~1.1 G operations against ~0.3 MB
// of traffic.  As a bitwise AND-reduction it runs on the int32 pipes; the
// same function is also two 0/1 matrix products over complement
// bit-planes, which K2 and K3 run on the int8 tensor cores for W <=
// TCF_MAX_W (frontier.cu).  K1 keeps the loop below for now.
//
// What the design does about it: one CTA per 8 candidates keeps the
// candidates in shared memory and streams the rows through L1/L2 (each
// row is read once per CTA and reused for all 8 candidates); the subset
// test exits at the first failing word; warps that hold no match skip the
// AND-reduction entirely (ballot == 0), and the reduction itself is one
// redux.sync per word per warp instead of a shuffle tree.  See
// closure_common.cuh for the shared loop.
#include "closure_common.cuh"

__global__ void __launch_bounds__(CLOSURE_THREADS)
closure_kernel(const uint32_t* __restrict__ rows,
               const uint32_t* __restrict__ cands,
               uint32_t* __restrict__ out_c,
               int* __restrict__ out_s,
               int N, int B, int W)
{
    extern __shared__ uint32_t smem[];
    // blockIdx.y is the object shard: one launch covers every shard of a
    // simulated plan's [K, N, W] rows and writes [K, B, W] / [K, B].
    const size_t shard = blockIdx.y;
    rows += shard * N * W;
    out_c += shard * B * W;
    out_s += shard * B;
    const int b0 = blockIdx.x * CLOSURE_GROUP;
    const int G = min(CLOSURE_GROUP, B - b0);
    ClosureSmem s = closure_setup(smem, cands, b0, G, W);
    closure_accumulate(rows, N, W, G, s);
    for (int i = threadIdx.x; i < G * W; i += blockDim.x)
        out_c[(size_t)b0 * W + i] = s.acc[i];
    for (int i = threadIdx.x; i < G; i += blockDim.x)
        out_s[b0 + i] = (int)s.sup[i];
}

// rows [K, N, W], cands [B, W] → out_c [K, B, W], out_s [K, B]; K, B >= 1.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int closure_launch(const void* rows, const void* cands,
                              void* out_c, void* out_s,
                              int K, int N, int B, int W, void* stream)
{
    const size_t smem = closure_smem_bytes(W);
    cudaError_t err = closure_smem_attr(closure_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((B + CLOSURE_GROUP - 1) / CLOSURE_GROUP, K);
    closure_kernel<<<grid, CLOSURE_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, (const uint32_t*)cands,
        (uint32_t*)out_c, (int*)out_s, N, B, W);
    return (int)cudaGetLastError();
}
