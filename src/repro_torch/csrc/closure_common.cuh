// Shared device code of the closure kernel (closure.cu) and the fused
// frontier-step kernel (frontier.cu).
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
// (2 * CLOSURE_GROUP * W + 2 * CLOSURE_GROUP) words, which bounds W at
// 3631 words (116,192 attributes) under the card's 227 KB per block; the
// Python wrappers raise above it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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
