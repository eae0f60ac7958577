// The serving kernels, hand-written for Hopper (sm_90a), one source and
// one build:
//
// K5 — contains top-k.  Replaces: src/repro/kernels/serve.py:contains_topk_call
// (body _contains_topk_kernel, _topk_int).  Per closed query s:
//   hit[c]   = (c < n_concepts) && all_w((gc[s, w] & ~intents[c, w]) == 0)
//   top k of {(supports[c], c) : hit[c], supports[c] >= 0}
//            by support descending, then concept index ascending
//   slots after the last hit are (-1, -1).
//
// K6 — rules top-k.  Replaces: src/repro/kernels/serve.py:rules_topk_call
// (body _rules_topk_kernel, _tree_or).  Per query s:
//   ok[r]    = (r < n_rules) && conf[r] >= min_conf (float32)
//              && all_w((prem[r, w] & ~q[s, w]) == 0)
//   union[s] = OR of added[r] over every ok rule (not only the top k)
//   top k of {(metric[r], rid[r], r) : ok[r], metric[r] >= 0}
//            by metric descending, then rule id ascending, then position
//   slots after the last hit are (-1, -1.0).
//
// n_concepts, n_rules, min_conf, S, C or R, W and k are plain launch
// arguments, so no threshold or table size forces a rebuild.  The TPU
// kernels hold the whole table in VMEM and fall back above 2^22 table
// cells or for slots that are not a multiple of 8; these stream the table
// from device memory, so they take any S (the tail CTA masks its missing
// queries), any C or R and any W.
//
// Any k >= 1: one launch selects at most SERVE_MAX_K winners, columns
// [k0, k0 + kp) of the [S, k] outputs.  Both orders are total, so pass
// k0 > 0 keeps only the entries strictly after the last winner of the
// pass before it (column k0 - 1 of the outputs, plus the winner's table
// position for K6, kept in a per-query cursor); a query whose previous
// pass ran out of hits gets (-1, -1) again.  k0 is a launch argument read
// at run time.  K6 ORs the union in pass 0 only.  Whether a pass is the
// first is a template flag (LATER), chosen at launch from the same build:
// pass 0 compiles to the one-pass body, with no cursor compare in its
// selection loop.
//
// What bounds it on the H100 (K5 and K6 alike): integer ALU issue for the
// subset test at large S (S*C*W word tests), device memory otherwise —
// the table is streamed once per query block.  At the serving shapes (S =
// 64 slots, a few thousand live rows, W = 4) the work is a few µs of the
// card's time, so latency bounds a launch: how many tiles one CTA walks
// one after the other, and how many SMs hold a CTA.
//
// What the design does about it: one warp per query, SERVE_WARPS queries
// per CTA, and the live table split across a second grid axis into up to
// SERVE_MAX_SLICES slices, sized so that query blocks x slices put about
// two CTAs on every SM (topk_plan, one plan for both kernels; at S = 64
// slots: 8 x 17 CTAs of one tile each against K5's 4,282 live intents, 8 x
// 21 against K6's 5,355 live rules).  Each CTA streams its slice through
// shared memory in tiles of TILE_ROWS rows x TILE_WORDS words (rows padded
// to an odd stride, so the 32 lanes of a warp read 32 banks), and every
// query of the CTA tests the whole tile: each table word is read from
// device memory once per query block.  Each lane owns rows lane, lane +
// 32, ... of the tile and keeps a sorted local top-k of its hits (in local
// memory; rows arrive in ascending order, so K5's ties need no index
// compare); after its slice the warp merges the 32 local lists in kp
// rounds of a shuffle argmax (warp_select, in the kernel's order) and
// writes its query's top kp to scratch.  The query block's last CTA to
// arrive (an arrival counter after a __threadfence) merges the slices'
// lists, lane l holding slice l's, in kp more rounds of warp_select; one
// slice takes the same path.  Indices (K5) and positions (K6) are unique,
// so the merges keep the total order exactly.  Every slice applies a later
// pass's cursor filter itself.  Rows at or past the live count are never
// read.  K6 also applies the confidence test and ORs the consequent words
// of its firing rules (__reduce_or_sync per warp, then one atomicOr per
// word into the union row, zeroed by the launcher before pass 0).
#include <cuda_runtime.h>
#include <stdint.h>

#define SERVE_WARPS 8
#define SERVE_THREADS (SERVE_WARPS * 32)
#define ROWS_PER_LANE 8
#define TILE_ROWS (32 * ROWS_PER_LANE)
#define TILE_WORDS 16
#define TILE_STRIDE (TILE_WORDS + 1)
#define SERVE_MAX_K 64
#define FULL_MASK 0xffffffffu
#define INT_MAX_ 0x7fffffff

struct ServeSmem {
    uint32_t tile[TILE_ROWS * TILE_STRIDE];
    uint32_t q[SERVE_WARPS * TILE_WORDS];
};

// Load words [c0, c0 + wc) of table rows [r0, r0 + TILE_ROWS) and of the
// CTA's queries into shared memory.  Rows at or past `limit` and missing
// queries read as 0 (they are masked by the caller).
__device__ __forceinline__ void load_tile(ServeSmem& sm,
                                          const uint32_t* __restrict__ table,
                                          const uint32_t* __restrict__ queries,
                                          long r0, int limit, int c0, int wc,
                                          int s0, int S, int W)
{
    for (int i = threadIdx.x; i < TILE_ROWS * wc; i += SERVE_THREADS) {
        const int row = i / wc, w = i - row * wc;
        const long r = r0 + row;
        sm.tile[row * TILE_STRIDE + w] = r < limit ? table[r * W + c0 + w] : 0u;
    }
    for (int i = threadIdx.x; i < SERVE_WARPS * wc; i += SERVE_THREADS) {
        const int g = i / wc, w = i - g * wc;
        const int s = s0 + g;
        sm.q[g * TILE_WORDS + w] = s < S ? queries[(long)s * W + c0 + w] : 0u;
    }
}

// Bit i of the result: row r0 + 32*i + lane fails the subset test.
// PREMISE_IN_QUERY: K6's premise ⊆ query; else K5's query ⊆ intent.
template <bool PREMISE_IN_QUERY>
__device__ __forceinline__ uint32_t tile_fail(ServeSmem& sm,
                                              const uint32_t* __restrict__ table,
                                              const uint32_t* __restrict__ queries,
                                              long r0, int limit, int s0, int S,
                                              int W, bool active, int warp, int lane)
{
    uint32_t fail = 0u;
    for (int c0 = 0; c0 < W; c0 += TILE_WORDS) {
        const int wc = min(TILE_WORDS, W - c0);
        __syncthreads();  // the previous pass's readers are done
        load_tile(sm, table, queries, r0, limit, c0, wc, s0, S, W);
        __syncthreads();
        if (!active) continue;
        const uint32_t* q = sm.q + warp * TILE_WORDS;
#pragma unroll
        for (int i = 0; i < ROWS_PER_LANE; ++i) {
            if (fail & (1u << i)) continue;
            const uint32_t* t = sm.tile + (32 * i + lane) * TILE_STRIDE;
            for (int w = 0; w < wc; ++w) {
                const uint32_t bad = PREMISE_IN_QUERY ? (t[w] & ~q[w]) : (q[w] & ~t[w]);
                if (bad) { fail |= 1u << i; break; }
            }
        }
    }
    return fail;
}

// ---------------------------------------------------------------------------
// What K5 and K6 share: the split of the table and the warp's selection
//
// grid = (query blocks of SERVE_WARPS, slices of the live table); a slice
// is `slice_rows` rows, planned from the live count and the SM count by
// topk_plan.  Each CTA writes its slice's top kp per query to `part`
// [S][nslice][kp] (past its hits, the kernel's empty entry), and the last
// CTA of a query block to arrive (`arrived`, zeroed by the launcher)
// merges the nslice lists of each of its queries.
// ---------------------------------------------------------------------------

#define SERVE_MAX_SLICES 32  // one slice per lane of the merging warp
#define SERVE_CTAS_PER_SM 2  // the plan's target: query blocks x slices per SM

// The orders of the top-k selections, on (value, key, position) triples
// with unique positions.  K5: support descending, then concept index
// ascending (its key and position are both the index; supports compare as
// int32, exactly).  K6: metric descending, then rule id ascending, then
// table position ascending (the order of the reference's k selection
// passes).
struct ContainsOrder {
    __device__ __forceinline__ bool operator()(int av, int ai, int, int bv, int bi, int) const
    {
        return av > bv || (av == bv && ai < bi);
    }
};

struct RuleOrder {
    __device__ __forceinline__ bool operator()(float av, int ar, int ap, float bv, int br,
                                               int bp) const
    {
        return av > bv || (av == bv && (ar < br || (ar == br && ap < bp)));
    }
};

// kp rounds of a warp-wide argmax in the order `before` over the lanes'
// sorted lists: head(p, v, r, q) loads entry p of this lane's list ((-1,
// INT_MAX, INT_MAX) past its end), and emit(t, hit, v, r, q) takes the
// t-th winner (hit: a real entry, v >= 0) on every lane.
template <typename V, typename Before, typename Head, typename Emit>
__device__ __forceinline__ void warp_select(int kp, Before before, Head head, Emit emit)
{
    int p = 0, hr, hp;
    V hv;
    head(0, hv, hr, hp);
    for (int t = 0; t < kp; ++t) {
        V bv = hv;
        int br = hr, bp = hp;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const V ov = __shfl_xor_sync(FULL_MASK, bv, off);
            const int orr = __shfl_xor_sync(FULL_MASK, br, off);
            const int op = __shfl_xor_sync(FULL_MASK, bp, off);
            if (before(ov, orr, op, bv, br, bp)) { bv = ov; br = orr; bp = op; }
        }
        const bool hit = bv >= V(0);
        if (hit && hp == bp) head(++p, hv, hr, hp);  // this lane's head won
        emit(t, hit, bv, br, bp);
    }
}

// The query block's last CTA to arrive, after every CTA wrote its lists:
// true on every thread of that CTA.
__device__ __forceinline__ bool last_to_arrive(int* arrived, int nslice)
{
    __shared__ int last_cta;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last_cta = atomicAdd(arrived + blockIdx.x, 1) == nslice - 1;
    __syncthreads();
    if (last_cta) __threadfence();
    return last_cta;
}

// The plan of K5 and K6 for S queries against `live` table rows on a card
// of `sms` SMs:
// rows [0, live) split into *nslice slices of *slice_rows rows (whole
// tiles), as many as put about SERVE_CTAS_PER_SM CTAs on each SM beside
// the *blocks query blocks, at most one per tile and SERVE_MAX_SLICES,
// and at least one (live <= 0 included).  Every live row lies in exactly
// one slice.  The caller sizes the launch's scratch from it.
extern "C" void topk_plan(int S, int live, int sms, int* slice_rows, int* nslice,
                                int* blocks)
{
    const long tiles = live > 0 ? ((long)live + TILE_ROWS - 1) / TILE_ROWS : 0;
    *blocks = (S + SERVE_WARPS - 1) / SERVE_WARPS;
    const long b = *blocks > 1 ? *blocks : 1;
    const long fill = ((long)SERVE_CTAS_PER_SM * sms + b - 1) / b;
    long want = tiles < SERVE_MAX_SLICES ? tiles : SERVE_MAX_SLICES;
    want = fill < want ? fill : want;
    if (want < 1) want = 1;
    const long tps = tiles > 0 ? (tiles + want - 1) / want : 1;
    *slice_rows = (int)(tps * TILE_ROWS);
    *nslice = tiles > 0 ? (int)((tiles + tps - 1) / tps) : 1;
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

template <int KMAX, bool LATER>
__global__ void __launch_bounds__(SERVE_THREADS)
contains_topk_kernel(const uint32_t* __restrict__ gc,
                     const uint32_t* __restrict__ intents,
                     const int* __restrict__ supports,
                     int* __restrict__ out_i, int* __restrict__ out_v,
                     int2* __restrict__ part, int* __restrict__ arrived,
                     int S, int limit, int W, int k, int k0, int kp, int slice_rows)
{
    __shared__ ServeSmem sm;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int s0 = blockIdx.x * SERVE_WARPS;
    const int s = s0 + warp;
    const bool active = s < S;
    const int nslice = gridDim.y, slice = blockIdx.y;
    const long r_lo = (long)slice * slice_rows;
    const long r_end = r_lo + slice_rows;
    const int r_hi = r_end < limit ? (int)r_end : limit;
    // the last winner of the previous pass: only entries after it count
    // (-1 after a pass that ran out of hits: then nothing is after it)
    int cv = INT_MAX_, ci = -1;
    if (LATER && active) {
        cv = out_v[(long)s * k + k0 - 1];
        ci = out_i[(long)s * k + k0 - 1];
    }

    int lv[KMAX], li[KMAX];  // this lane's hits: support desc, index asc
    int cnt = 0;
    for (long r0 = r_lo; r0 < r_hi; r0 += TILE_ROWS) {
        const uint32_t fail = tile_fail<false>(sm, intents, gc, r0, r_hi, s0, S, W,
                                               active, warp, lane);
        if (!active) continue;
#pragma unroll
        for (int i = 0; i < ROWS_PER_LANE; ++i) {
            const long r = r0 + 32 * i + lane;
            if (r >= r_hi || (fail & (1u << i))) continue;
            const int v = supports[r];
            if (v < 0 || (cnt == kp && v <= lv[kp - 1])) continue;
            if (LATER && (v > cv || (v == cv && r <= ci))) continue;  // taken in an earlier pass
            // rows arrive in ascending order: an equal value stays behind
            int j = cnt < kp ? cnt++ : kp - 1;
            while (j > 0 && lv[j - 1] < v) { lv[j] = lv[j - 1]; li[j] = li[j - 1]; --j; }
            lv[j] = v;
            li[j] = (int)r;
        }
    }

    if (active) {
        // the 32 lanes' lists → this CTA's top kp of each query, to scratch
        int2* mine = part + ((long)s * nslice + slice) * kp;
        warp_select<int>(kp, ContainsOrder(), [&](int p, int& v, int& i, int& q) {
            const bool has = p < cnt;
            v = has ? lv[p] : -1;
            i = q = has ? li[p] : INT_MAX_;
        }, [&](int t, bool, int v, int i, int) {
            if (lane == 0) mine[t] = make_int2(v, i);
        });
    }

    // the query block's last CTA merges the slices' lists
    if (!last_to_arrive(arrived, nslice) || !active) return;
    const int2* list = part + ((long)s * nslice + lane) * kp;
    warp_select<int>(kp, ContainsOrder(), [&](int p, int& v, int& i, int& q) {
        const int2 e = lane < nslice && p < kp ? __ldcg(list + p) : make_int2(-1, INT_MAX_);
        v = e.x;
        i = q = e.y;
    }, [&](int t, bool hit, int v, int i, int) {
        if (lane == 0) {
            out_i[(long)s * k + k0 + t] = hit ? i : -1;
            out_v[(long)s * k + k0 + t] = hit ? v : -1;
        }
    });
}

template <int KMAX, bool LATER>
static int launch_contains(const void* gc, const void* intents, const void* supports,
                           void* out_i, void* out_v, void* part, void* arrived,
                           int S, int limit, int W, int k, int k0, int kp,
                           int slice_rows, int nslice, cudaStream_t stream)
{
    const int blocks = (S + SERVE_WARPS - 1) / SERVE_WARPS;
    const cudaError_t err = cudaMemsetAsync(arrived, 0, (size_t)blocks * 4, stream);
    if (err != cudaSuccess) return (int)err;
    contains_topk_kernel<KMAX, LATER><<<dim3(blocks, nslice), SERVE_THREADS, 0, stream>>>(
        (const uint32_t*)gc, (const uint32_t*)intents, (const int*)supports,
        (int*)out_i, (int*)out_v, (int2*)part, (int*)arrived, S, limit, W, k, k0, kp,
        slice_rows);
    return (int)cudaGetLastError();
}

// gc [S, W], intents [C, W], supports [C] → columns [k0, k0 + kp) of
// out_i, out_v [S, k]; S >= 1, 0 <= k0, 1 <= kp <= SERVE_MAX_K,
// k0 + kp <= k, and columns [0, k0) written by the passes before.  The
// live intents are split into 1 <= nslice <= SERVE_MAX_SLICES slices of
// slice_rows rows, which must cover them, as topk_plan gives them; part is
// int2 scratch [S][nslice][kp] and arrived int32 scratch [the plan's
// blocks].  Launches one pass on `stream` and returns cudaGetLastError()
// (0 on success), or the error that stopped the launch.
extern "C" int contains_topk_launch(const void* gc, const void* intents,
                                    const void* supports, void* out_i, void* out_v,
                                    void* part, void* arrived,
                                    int S, int C, int W, int n_concepts, int k,
                                    int k0, int kp, int slice_rows, int nslice,
                                    void* stream)
{
    const int limit = n_concepts < 0 ? 0 : (n_concepts < C ? n_concepts : C);
    if (kp < 1 || kp > SERVE_MAX_K || k0 < 0 || k0 + kp > k || slice_rows < 1 ||
        nslice < 1 || nslice > SERVE_MAX_SLICES || (long)nslice * slice_rows < limit ||
        part == nullptr || arrived == nullptr)
        return (int)cudaErrorInvalidValue;
#define CONTAINS_CASE(KMAX, LATER)                                                       \
    return launch_contains<KMAX, LATER>(gc, intents, supports, out_i, out_v, part, arrived, \
                                        S, limit, W, k, k0, kp, slice_rows, nslice,       \
                                        (cudaStream_t)stream)
    if (kp <= 8) {
        if (k0 == 0) CONTAINS_CASE(8, false);
        CONTAINS_CASE(8, true);
    }
    if (k0 == 0) CONTAINS_CASE(SERVE_MAX_K, false);
    CONTAINS_CASE(SERVE_MAX_K, true);
#undef CONTAINS_CASE
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

template <int KMAX, bool LATER>
__global__ void __launch_bounds__(SERVE_THREADS)
rules_topk_kernel(const uint32_t* __restrict__ prem,
                  const uint32_t* __restrict__ added,
                  const float* __restrict__ conf,
                  const float* __restrict__ metric,
                  const int* __restrict__ rid,
                  const uint32_t* __restrict__ queries,
                  int* __restrict__ out_i, float* __restrict__ out_v,
                  uint32_t* __restrict__ out_u, int* __restrict__ cursor,
                  int4* __restrict__ part, int* __restrict__ arrived,
                  int S, int limit, int W, float min_conf, int k, int k0, int kp,
                  int slice_rows)
{
    __shared__ ServeSmem sm;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int s0 = blockIdx.x * SERVE_WARPS;
    const int s = s0 + warp;
    const bool active = s < S;
    const int nslice = gridDim.y, slice = blockIdx.y;
    const long r_lo = (long)slice * slice_rows;
    const long r_end = r_lo + slice_rows;
    const int r_hi = r_end < limit ? (int)r_end : limit;
    // the last winner of the previous pass: only entries after it count
    // (metric -1 after a pass that ran out of hits: nothing is after it)
    const RuleOrder before{};
    float cv = __int_as_float(0x7f800000);  // +inf: pass 0 keeps every entry
    int cr = -1, cp = -1;
    if (LATER && active) {
        cv = out_v[(long)s * k + k0 - 1];
        cr = out_i[(long)s * k + k0 - 1];
        cp = cursor[s];
    }

    float lv[KMAX];  // this lane's hits, in rule order
    int lr[KMAX], lp[KMAX];
    int cnt = 0;
    float tv = 0.0f;  // the kp-th entry, once the list is full
    int tr = 0, tp = 0;
    for (long r0 = r_lo; r0 < r_hi; r0 += TILE_ROWS) {
        // this lane's rows' confidences, metrics and rule ids: loaded all at
        // once, while the tile's premises stream in, not one row after another
        float rc[ROWS_PER_LANE], rv[ROWS_PER_LANE];
        int ri[ROWS_PER_LANE];
#pragma unroll
        for (int i = 0; i < ROWS_PER_LANE; ++i) {
            const long r = r0 + 32 * i + lane;
            const bool in = active && r < r_hi;
            rc[i] = in ? __ldg(conf + r) : 0.0f;
            rv[i] = in ? __ldg(metric + r) : -1.0f;
            ri[i] = in ? __ldg(rid + r) : 0;
        }
        const uint32_t fail = tile_fail<true>(sm, prem, queries, r0, r_hi, s0, S, W,
                                              active, warp, lane);
        if (!active) continue;
        uint32_t ok = 0u;
#pragma unroll
        for (int i = 0; i < ROWS_PER_LANE; ++i) {
            const long r = r0 + 32 * i + lane;
            if (r >= r_hi || (fail & (1u << i)) || !(rc[i] >= min_conf)) continue;
            ok |= 1u << i;
            const float v = rv[i];
            const int id = ri[i], pos = (int)r;
            if (!(v >= 0.0f)) continue;
            if (LATER && !before(cv, cr, cp, v, id, pos)) continue;  // taken in an earlier pass
            if (cnt == kp && !before(v, id, pos, tv, tr, tp)) continue;
            int j = cnt < kp ? cnt++ : kp - 1;
            while (j > 0 && before(v, id, pos, lv[j - 1], lr[j - 1], lp[j - 1])) {
                lv[j] = lv[j - 1]; lr[j] = lr[j - 1]; lp[j] = lp[j - 1]; --j;
            }
            lv[j] = v; lr[j] = id; lp[j] = pos;
            if (cnt == kp) { tv = lv[kp - 1]; tr = lr[kp - 1]; tp = lp[kp - 1]; }
        }
        if constexpr (!LATER) {
            if (!__any_sync(FULL_MASK, ok != 0u)) continue;
            // the consequent union of this tile's firing rules, four words at
            // a time (their loads all in flight at once), into the row the
            // launcher zeroed (slices meet there)
            for (int w0 = 0; w0 < W; w0 += 4) {
                uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
                for (int i = 0; i < ROWS_PER_LANE; ++i) {
                    const uint32_t* a = added + (r0 + 32 * i + lane) * (long)W + w0;
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        if ((ok & (1u << i)) && w0 + u < W) acc[u] |= __ldg(a + u);
                }
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const uint32_t x = __reduce_or_sync(FULL_MASK, acc[u]);
                    if (lane == 0 && x) atomicOr(out_u + (long)s * W + w0 + u, x);
                }
            }
        }
    }

    if (active) {
        // the 32 lanes' lists → this CTA's top kp of each query, to scratch
        int4* mine = part + ((long)s * nslice + slice) * kp;
        warp_select<float>(kp, RuleOrder(), [&](int p, float& v, int& r, int& pos) {
            const bool has = p < cnt;
            v = has ? lv[p] : -1.0f;
            r = has ? lr[p] : INT_MAX_;
            pos = has ? lp[p] : INT_MAX_;
        }, [&](int t, bool, float v, int r, int pos) {
            if (lane == 0) mine[t] = make_int4(__float_as_int(v), r, pos, 0);
        });
    }

    // the query block's last CTA merges the slices' lists
    if (!last_to_arrive(arrived, nslice) || !active) return;
    const int4* list = part + ((long)s * nslice + lane) * kp;
    warp_select<float>(kp, RuleOrder(), [&](int p, float& v, int& r, int& pos) {
        const int4 e = lane < nslice && p < kp ? __ldcg(list + p)
                                               : make_int4(__float_as_int(-1.0f), INT_MAX_,
                                                           INT_MAX_, 0);
        v = __int_as_float(e.x);
        r = e.y;
        pos = e.z;
    }, [&](int t, bool hit, float v, int r, int pos) {
        if (lane == 0) {
            out_i[(long)s * k + k0 + t] = hit ? r : -1;
            out_v[(long)s * k + k0 + t] = hit ? v : -1.0f;
            if (cursor != nullptr && t == kp - 1) cursor[s] = hit ? pos : -1;
        }
    });
}

template <int KMAX, bool LATER>
static int launch_rules(const void* prem, const void* added, const void* conf,
                        const void* metric, const void* rid, const void* queries,
                        void* out_i, void* out_v, void* out_u, void* cursor,
                        void* part, void* arrived,
                        int S, int limit, int W, float min_conf, int k, int k0, int kp,
                        int slice_rows, int nslice, cudaStream_t stream)
{
    const int blocks = (S + SERVE_WARPS - 1) / SERVE_WARPS;
    cudaError_t err = cudaSuccess;
    if (!LATER)  // the union's identity: the first pass ORs every slice into it
        err = cudaMemsetAsync(out_u, 0, (size_t)S * W * 4, stream);
    if (err == cudaSuccess)
        err = cudaMemsetAsync(arrived, 0, (size_t)blocks * 4, stream);
    if (err != cudaSuccess) return (int)err;
    rules_topk_kernel<KMAX, LATER><<<dim3(blocks, nslice), SERVE_THREADS, 0, stream>>>(
        (const uint32_t*)prem, (const uint32_t*)added, (const float*)conf,
        (const float*)metric, (const int*)rid, (const uint32_t*)queries,
        (int*)out_i, (float*)out_v, (uint32_t*)out_u, (int*)cursor,
        (int4*)part, (int*)arrived, S, limit, W, min_conf, k, k0, kp, slice_rows);
    return (int)cudaGetLastError();
}

// prem, added [R, W], conf, metric [R] f32, rid [R], queries [S, W]
// → columns [k0, k0 + kp) of out_i [S, k] and out_v [S, k] f32, and (pass
// k0 = 0) out_u [S, W]; S >= 1, 0 <= k0, 1 <= kp <= SERVE_MAX_K,
// k0 + kp <= k.  cursor [S] int32 carries each query's last winner's
// position from one pass to the next; it may be null when k0 + kp == k
// and k0 == 0.  min_conf arrives already rounded to float32.  The live
// rules are split into 1 <= nslice <= SERVE_MAX_SLICES slices of
// slice_rows rows, which must cover them, as topk_plan gives them;
// part is int4 scratch [S][nslice][kp] and arrived int32 scratch [the
// plan's blocks].  Launches one pass on `stream` and returns
// cudaGetLastError() (0 on success), or the error that stopped the launch.
extern "C" int rules_topk_launch(const void* prem, const void* added, const void* conf,
                                 const void* metric, const void* rid,
                                 const void* queries, void* out_i, void* out_v,
                                 void* out_u, void* cursor, void* part, void* arrived,
                                 int S, int R, int W, int n_rules, float min_conf, int k,
                                 int k0, int kp, int slice_rows, int nslice,
                                 void* stream)
{
    const int limit = n_rules < 0 ? 0 : (n_rules < R ? n_rules : R);
    if (kp < 1 || kp > SERVE_MAX_K || k0 < 0 || k0 + kp > k ||
        (cursor == nullptr && (k0 > 0 || k0 + kp < k)) || slice_rows < 1 || nslice < 1 ||
        nslice > SERVE_MAX_SLICES || (long)nslice * slice_rows < limit ||
        part == nullptr || arrived == nullptr)
        return (int)cudaErrorInvalidValue;
#define RULES_CASE(KMAX, LATER)                                                         \
    return launch_rules<KMAX, LATER>(prem, added, conf, metric, rid, queries, out_i,     \
                                     out_v, out_u, cursor, part, arrived, S, limit, W,   \
                                     min_conf, k, k0, kp, slice_rows, nslice,          \
                                     (cudaStream_t)stream)
    if (kp <= 8) {
        if (k0 == 0) RULES_CASE(8, false);
        RULES_CASE(8, true);
    }
    if (k0 == 0) RULES_CASE(SERVE_MAX_K, false);
    RULES_CASE(SERVE_MAX_K, true);
#undef RULES_CASE
}
