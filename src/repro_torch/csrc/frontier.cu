// The frontier-step kernels: K2 (below), and K3 / K4, its two halves on
// multi-shard plans (at the end of this file), hand-written for Hopper
// (sm_90a), one source and one build.
//
// K2 — the fused frontier step (closure → support → driver filter).
//
// Replaces: src/repro/kernels/frontier.py:fused_closure_call (body
// _fused_kernel, _keep_mask, _row_valid).  K1's closure loop followed by
// the epilogue of _fused_kernel, per candidate b of the chunk:
//   closure[b] = (AND of matching rows) & mask
//   support[b] = matches - n_pad
//   keep[b]    = (b + row_off < n_valid)
//                && (!ICEBERG || support[b] >= min_sup)
//                && (!CBO || ((closure[b] ^ parent[b]) & lowrow[b]) == 0)
// n_valid, min_sup, n_pad and row_off are plain int launch arguments, so
// no threshold or window forces a rebuild; ICEBERG and CBO are template
// parameters (four instantiations).  CbO's LOW[gen] gather stays outside
// the kernel, as in the reference engine (lowrow = LOW[gens]).
//
// What bounds it on the H100: the same integer ALU issue as K1 — the
// epilogue adds ~3*B*W word operations and B*(2W + 1) words of traffic to
// K1's ~4*B*N*W operations.  What the design does about it: the epilogue
// runs on the accumulators while they are still in shared memory, so the
// closure block is written once, already masked, and the survivor mask
// comes out of the same pass (the reference's reason to fuse).
#include "closure_common.cuh"

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
                  int N, int B, int W,
                  int n_valid, int min_sup, int n_pad, int row_off)
{
    extern __shared__ uint32_t smem[];
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

template <bool ICEBERG, bool CBO>
static int launch(const void* rows, const void* cands, const void* mask,
                  const void* parent, const void* lowrow,
                  void* out_c, void* out_s, void* keep,
                  int N, int B, int W,
                  int n_valid, int min_sup, int n_pad, int row_off,
                  cudaStream_t stream)
{
    const size_t smem = closure_smem_bytes(W);
    cudaError_t err = closure_smem_attr(fused_step_kernel<ICEBERG, CBO>, smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = (B + CLOSURE_GROUP - 1) / CLOSURE_GROUP;
    fused_step_kernel<ICEBERG, CBO><<<grid, CLOSURE_THREADS, smem, stream>>>(
        (const uint32_t*)rows, (const uint32_t*)cands, (const uint32_t*)mask,
        (const uint32_t*)parent, (const uint32_t*)lowrow,
        (uint32_t*)out_c, (int*)out_s, (uint8_t*)keep,
        N, B, W, n_valid, min_sup, n_pad, row_off);
    return (int)cudaGetLastError();
}

// rows [N, W], cands [B, W], mask [W], parent/lowrow [B, W] (CbO only,
// else null) → out_c [B, W], out_s [B], keep [B] (bool bytes); B >= 1.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fused_step_launch(const void* rows, const void* cands,
                                 const void* mask, const void* parent,
                                 const void* lowrow, void* out_c,
                                 void* out_s, void* keep,
                                 int N, int B, int W,
                                 int n_valid, int min_sup, int n_pad,
                                 int row_off, int iceberg, int cbo,
                                 void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    if (iceberg && cbo)
        return launch<true, true>(rows, cands, mask, parent, lowrow, out_c,
                                  out_s, keep, N, B, W, n_valid, min_sup,
                                  n_pad, row_off, st);
    if (iceberg)
        return launch<true, false>(rows, cands, mask, parent, lowrow, out_c,
                                   out_s, keep, N, B, W, n_valid, min_sup,
                                   n_pad, row_off, st);
    if (cbo)
        return launch<false, true>(rows, cands, mask, parent, lowrow, out_c,
                                   out_s, keep, N, B, W, n_valid, min_sup,
                                   n_pad, row_off, st);
    return launch<false, false>(rows, cands, mask, parent, lowrow, out_c,
                                out_s, keep, N, B, W, n_valid, min_sup,
                                n_pad, row_off, st);
}

// ---------------------------------------------------------------------------
// K3 — the map half of a multi-shard round, hand-written for Hopper.
//
// Replaces: src/repro/kernels/frontier.py:map_closure_call (body
// _map_kernel).  Per object shard k (blockIdx.y) and candidate b:
//   closure[k, b] = (AND of shard k's matching rows) & mask
//   support[k, b] = number of shard k's matching rows     (raw)
// One launch covers every shard of a simulated plan's [K, N, W] rows, the
// counterpart of jax.vmap batching the Pallas grid; a process-group rank
// launches it with K = 1 on its own slice.  No pad correction here: the
// all-ones pad rows sit in the last shard and are subtracted once, after
// the support sum.
//
// What bounds it on the H100: K1's integer ALU issue, ~4*B*N*W word
// operations summed over the shards, against (K*N*W + B*W) words read and
// K*B*(W + 1) written.  What the design does about it: K1's loop (one CTA
// per 8 candidates and shard, warp ballot + __reduce_and_sync), with the
// mask applied while the accumulators are still in shared memory.
// ---------------------------------------------------------------------------

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
        out_c[(size_t)b0 * W + i] = s.acc[i] & mask[i % W];
    for (int i = threadIdx.x; i < G; i += blockDim.x)
        out_s[b0 + i] = (int)s.sup[i];
}

// rows [K, N, W], cands [B, W], mask [W] → out_c [K, B, W], out_s [K, B];
// K, B >= 1.  Launches on `stream` and returns cudaGetLastError().
extern "C" int map_closure_launch(const void* rows, const void* cands,
                                  const void* mask, void* out_c, void* out_s,
                                  int K, int N, int B, int W, void* stream)
{
    const size_t smem = closure_smem_bytes(W);
    cudaError_t err = closure_smem_attr(map_closure_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((B + CLOSURE_GROUP - 1) / CLOSURE_GROUP, K);
    map_closure_kernel<<<grid, CLOSURE_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, (const uint32_t*)cands, (const uint32_t*)mask,
        (uint32_t*)out_c, (int*)out_s, N, B, W);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4 — the filter half of a multi-shard round, hand-written for Hopper.
//
// Replaces: src/repro/kernels/frontier.py:filter_call (body
// _filter_kernel, _keep_mask, _row_valid).  After the AND-allreduce and
// the support sum, per candidate b:
//   support[b] = gs[b] - n_pad
//   keep[b]    = (b + row_off < n_valid)
//                && (!ICEBERG || support[b] >= min_sup)
//                && (!CBO || ((gc[b] ^ parent[b]) & lowrow[b]) == 0)
// n_valid, min_sup, n_pad and row_off are plain int launch arguments, so
// nothing is rebuilt per threshold; ICEBERG and CBO are template
// parameters.  The engine passes n_pad = 0: the supports arrive already
// corrected, as in the reference.
//
// What bounds it on the H100: memory.  It reads B*(W + 1) words (3*B*W + B
// for CbO) and writes B words and B bytes, with a handful of operations
// per word.  What the design does about it: one thread per candidate row,
// so each row is read once; the CbO test stops at the first word that
// fails and is skipped for rows already out.  At the main path's batches
// (B <= 8192) the launch is latency, not bandwidth.
// ---------------------------------------------------------------------------

#define FILTER_THREADS 256

template <bool ICEBERG, bool CBO>
__global__ void __launch_bounds__(FILTER_THREADS)
filter_kernel(const uint32_t* __restrict__ gc,
              const int* __restrict__ gs,
              const uint32_t* __restrict__ parent,
              const uint32_t* __restrict__ lowrow,
              int* __restrict__ out_s,
              uint8_t* __restrict__ keep,
              int B, int W, int n_valid, int min_sup, int n_pad, int row_off)
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int sup = gs[b] - n_pad;
    out_s[b] = sup;
    bool k = b + row_off < n_valid;
    if (ICEBERG) k = k && sup >= min_sup;
    if (CBO && k) {
        const size_t o = (size_t)b * W;
        for (int w = 0; w < W; ++w) {
            if (((gc[o + w] ^ parent[o + w]) & lowrow[o + w]) != 0u) {
                k = false;  // not canonical
                break;
            }
        }
    }
    keep[b] = k ? 1 : 0;
}

template <bool ICEBERG, bool CBO>
static int launch_filter(const void* gc, const void* gs, const void* parent,
                         const void* lowrow, void* out_s, void* keep,
                         int B, int W, int n_valid, int min_sup, int n_pad,
                         int row_off, cudaStream_t stream)
{
    const int grid = (B + FILTER_THREADS - 1) / FILTER_THREADS;
    filter_kernel<ICEBERG, CBO><<<grid, FILTER_THREADS, 0, stream>>>(
        (const uint32_t*)gc, (const int*)gs, (const uint32_t*)parent,
        (const uint32_t*)lowrow, (int*)out_s, (uint8_t*)keep,
        B, W, n_valid, min_sup, n_pad, row_off);
    return (int)cudaGetLastError();
}

// gc [B, W], gs [B], parent/lowrow [B, W] (CbO only, else null) →
// out_s [B], keep [B] (bool bytes); B >= 1.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int filter_launch(const void* gc, const void* gs,
                             const void* parent, const void* lowrow,
                             void* out_s, void* keep, int B, int W,
                             int n_valid, int min_sup, int n_pad, int row_off,
                             int iceberg, int cbo, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    if (iceberg && cbo)
        return launch_filter<true, true>(gc, gs, parent, lowrow, out_s, keep, B,
                                         W, n_valid, min_sup, n_pad, row_off, st);
    if (iceberg)
        return launch_filter<true, false>(gc, gs, parent, lowrow, out_s, keep, B,
                                          W, n_valid, min_sup, n_pad, row_off, st);
    if (cbo)
        return launch_filter<false, true>(gc, gs, parent, lowrow, out_s, keep, B,
                                          W, n_valid, min_sup, n_pad, row_off, st);
    return launch_filter<false, false>(gc, gs, parent, lowrow, out_s, keep, B, W,
                                       n_valid, min_sup, n_pad, row_off, st);
}
