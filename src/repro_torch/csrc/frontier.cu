// K2 — the fused frontier step (closure → support → driver filter),
// hand-written for Hopper (sm_90a).
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
