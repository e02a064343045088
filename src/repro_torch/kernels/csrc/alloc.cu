// W-round rotating-priority switch allocation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `alloc_rounds_pallas` (body
// `_alloc_kernel`) of src/repro/kernels/alloc.py, whose math is
// `_alloc_rounds_math` in src/repro/kernels/ref.py.  It runs once in
// every simulated cycle of the flit engine (SwitchCore.alloc).
//
// Contract (int32 everywhere; L lanes, N routers, PV = P*V network queues
// and PE source queues per router, K = PV + PE < KSHIFT requests):
//   in   out_n/ej_n/sp_n [L, N, PV, W], cnt_n [L, N, PV],
//        out_s/ej_s/sp_s [L, N, PE, W], cnt_s [L, N, PE], epr [N],
//        cyc: lane l's cycle at cyc[l * cyc_stride] (stride 0: one cycle
//        for every lane), in device memory
//   out  cs_n/es_n [L, N, PV], cs_s/es_s [L, N, PE]  granted window offset
//        by kind (-1 = none); win_req [L, N, P] winning request per port
// Lanes are independent sweep points (blockIdx.y): the priorities use the
// lane's own cycle and the lane-local queue ids, so lane l's grants equal
// a single-lane call's on its arrays.
// Each round w: ejection grants go to the requests ranked below the
// router's remaining budget of p ejection ports, ranked by rotated
// exclusive prefix counts (net queues from column cycle % PV, before or
// after the source queues by cycle parity); then each output port grants
// the live request with the least ((qidx + cycle*7919 + w*131) mod R)
// * 256 + k.  W is 1..8; one instantiation per W and per NJ =
// ceil(K / 32), the request rows a lane holds.
//
// Bound on this card.  The call must read ~8.0 MB and write ~0.9 MB at
// q=19, W=6 (2.4 us at 3.35 TB/s).  The work per router is a few hundred
// integer operations per round, so what costs time beyond the bytes is
// latency: the loads of each round and the synchronisation between a
// router's requests, W times over, with only 722 routers (about one warp
// per scheduler) to hide it.
//
// Design.  One warp per router, four routers per block, and no block
// barrier at all.  A lane owns requests lane + 32 j (5 of them at q=19,
// K = 131; 6 at q=25).  Before round 0 the warp stages its router's
// contiguous rows of out, ej and sp into shared memory, each row block by
// one TMA bulk copy of its 16-byte aligned middle (the ragged ends by
// lanes; the PE rows are not 16-byte aligned at every shape), all in
// flight together beside the depth loads; then each lane packs its
// requests' W slots into registers: the out ports as bytes, and W-bit
// masks of the slots that want to eject and that want a channel (valid
// by depth, space, a port).  The rounds touch no device memory and
// branch on nothing but uniform loop bounds.  The ejection ranks come
// from one exclusive prefix per round, X(k) = row prefix (popcount of a
// ballot below the lane) + earlier rows' totals: net queues come first,
// so X is the net prefix below PV and the net total plus the source
// prefix above; X at s_rot and at PV are read from their lanes with a
// shuffle.  The grant count is a popcount of a ballot.  The channel
// winner of each output port is a shared-memory atomicMin of the packed
// priority in the warp's own region (a lane that is not live updates its
// own spare slot), between two __syncwarp: min does not depend on the
// order of the atomics and the packed values are distinct, so
// `cmb == cmin[out]` names exactly one winner.  `taken` is the router's
// bitmask of ports granted in earlier rounds (256 bits in shared memory;
// P = 37 at q=25).  The rotation advances by 131 mod R per round without
// a division.  Every modulo operand is non-negative (cycle <= 200k keeps
// cycle*7919 + qidx + w*131 below 2^31; rows with epr = -1 still have
// qidx = NQ - PE + k >= 0 and are masked by cnt_s == 0), so C's % equals
// jnp's floor-mod, and the result is bit-exact against the plain version.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int KSHIFT = 256;
constexpr int RPB = 4;                  // routers (warps) per block
constexpr int NT = 32 * RPB;
constexpr unsigned NO_PORT = 0xffu;

// ---- mbarrier and TMA bulk copy (PTX)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t par) {
    const uint32_t a = smem_u32(bar);
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(a), "r"(par) : "memory");
    }
}
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// n ints at `src`: its phase (ints past a 16-byte boundary) and the
// 16-byte aligned middle [a0, a1) that one bulk copy can move
struct Row {
    const int* src;
    int n, ph, a0, a1;
    __device__ Row(const int* s, int n_) : src(s), n(n_) {
        ph = (int)((reinterpret_cast<uintptr_t>(s) >> 2) & 3);
        a0 = min((4 - ph) & 3, n);
        a1 = a0 + ((n - a0) & ~3);
    }
    __device__ uint32_t bytes() const { return (uint32_t)(a1 - a0) * 4u; }
    // into region `reg` (n + 4 ints, 16-byte aligned) at offset ph: the
    // middle by a bulk copy (lane 0), the ragged ends by lanes
    __device__ void stage(int* reg, uint64_t* bar, int lane) const {
        int* dst = reg + ph;
        if (lane == 0 && a1 > a0) bulk_g2s(dst + a0, src + a0, bytes(), bar);
        if (lane < a0) dst[lane] = src[lane];
        if (lane < n - a1) dst[a1 + lane] = src[a1 + lane];
    }
};

// Per-warp shared memory (ints): the six W-slot regions, cmin, taken.
__host__ __device__ inline int region_ints(int n) { return (n + 4 + 3) & ~3; }
__host__ __device__ inline int warp_ints(int PV, int PE, int W) {
    return 3 * (region_ints(PV * W) + region_ints(PE * W)) + KSHIFT + 32
           + KSHIFT / 32 + 4;       // + mbarrier (8 bytes, 8-aligned)
}

// X(i) of the exclusive prefix X held as X[i / 32] in lane i % 32 (the
// total `tot` for i past the last row); i is the same in every lane
template <int NJ>
__device__ __forceinline__ int prefix_at(const int (&X)[NJ], int i, int tot) {
    const int row = i >> 5;
    int x = X[0];
#pragma unroll
    for (int j = 1; j < NJ; ++j) x = row == j ? X[j] : x;
    x = __shfl_sync(0xffffffffu, x, i & 31);
    return row < NJ ? x : tot;
}

// W slots per request, NJ = ceil(K / 32) request rows per lane
template <int W, int NJ>
__global__ void __launch_bounds__(NT)
alloc_kernel(const int* __restrict__ cyc, int cyc_stride,
             const int* __restrict__ out_n, const int* __restrict__ ej_n,
             const int* __restrict__ sp_n, const int* __restrict__ cnt_n,
             const int* __restrict__ out_s, const int* __restrict__ ej_s,
             const int* __restrict__ sp_s, const int* __restrict__ cnt_s,
             const int* __restrict__ epr,
             int* __restrict__ cs_n, int* __restrict__ es_n,
             int* __restrict__ cs_s, int* __restrict__ es_s,
             int* __restrict__ win_req,
             int N, int P, int V, int PE, int p_budget, int NQ, int R) {
    extern __shared__ __align__(16) int smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int r = blockIdx.x * RPB + warp;
    if (r >= N) return;                 // no block barrier below
    const int PV = P * V;
    const int K = PV + PE;
    // this sweep lane's arrays and cycle
    const size_t ln = blockIdx.y;
    const size_t lpv = ln * N * PV, lpe = ln * N * PE;
    out_n += lpv * W; ej_n += lpv * W; sp_n += lpv * W; cnt_n += lpv;
    out_s += lpe * W; ej_s += lpe * W; sp_s += lpe * W; cnt_s += lpe;
    cs_n += lpv; es_n += lpv; cs_s += lpe; es_s += lpe;
    win_req += ln * N * P;
    const int cycle = cyc[ln * cyc_stride];
    const int rn = region_ints(PV * W), rs = region_ints(PE * W);
    int* reg = smem + warp * warp_ints(PV, PE, W);
    int* cmin = reg + 3 * (rn + rs);    // per output port, this round,
                                        // then a spare slot per lane
    unsigned* taken = reinterpret_cast<unsigned*>(cmin + KSHIFT + 32);
    uint64_t* bar = reinterpret_cast<uint64_t*>(taken + KSHIFT / 32);
    const unsigned lt = (1u << lane) - 1u;   // lanes below this one

    // ---- stage the router's contiguous W-slot rows: one bulk copy per
    // row block, in flight together, beside the depth loads
    const size_t bn = (size_t)r * PV * W, bs = (size_t)r * PE * W;
    const Row rows[6] = {Row(out_n + bn, PV * W), Row(ej_n + bn, PV * W),
                         Row(sp_n + bn, PV * W), Row(out_s + bs, PE * W),
                         Row(ej_s + bs, PE * W), Row(sp_s + bs, PE * W)};
    int* rsrc = reg + 3 * rn;
    int* dst[6] = {reg, reg + rn, reg + 2 * rn, rsrc, rsrc + rs,
                   rsrc + 2 * rs};
    if (lane == 0) {
        uint32_t tx = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i) tx += rows[i].bytes();
        mbar_init(bar, 1);
        mbar_expect_tx(bar, tx);        // before the copies it counts
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 6; ++i) rows[i].stage(dst[i], bar, lane);
    const int ph_on = rows[0].ph, ph_en = rows[1].ph, ph_sn = rows[2].ph;
    const int ph_os = rows[3].ph, ph_es = rows[4].ph, ph_ss = rows[5].ph;
    int cnt[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int k = lane + 32 * j;
        cnt[j] = 0;
        if (k < K)
            cnt[j] = k < PV ? cnt_n[(size_t)r * PV + k]
                            : cnt_s[(size_t)r * PE + (k - PV)];
    }
    const int e_r = epr[r];
    if (lane < KSHIFT / 32) taken[lane] = 0u;
    const int s_rot = cycle % PV;
    const bool net_first = (cycle % 2) == 0;
    const int step = 131 % R;           // rotation added per round
    mbar_wait(bar, 0);
    __syncwarp();                       // the lanes' ragged ends

    // ---- this lane's requests in registers: out ports as bytes, and
    // W-bit masks of the slots that want to eject / a channel (valid by
    // depth, with space and a port), then rotation and row masks
    int rot[NJ];                        // (qidx + cycle*7919 + w*131) % R
    uint2 outw[NJ];                     // out port of slot w: byte w
    unsigned wej[NJ], wch[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int k = lane + 32 * j;
        const bool req = k < K;         // lanes past K hold no request
        const int kc = min(k, K - 1);
        const bool net = kc < PV;
        const int qidx = net ? r * PV + kc : NQ + e_r * PE + (kc - PV);
        rot[j] = (qidx + cycle * 7919) % R;
        const int* ro = net ? reg + ph_on + kc * W
                            : rsrc + ph_os + (kc - PV) * W;
        const int* re = net ? reg + rn + ph_en + kc * W
                            : rsrc + rs + ph_es + (kc - PV) * W;
        const int* rp = net ? reg + 2 * rn + ph_sn + kc * W
                            : rsrc + 2 * rs + ph_ss + (kc - PV) * W;
        unsigned lo = 0xffffffffu, hi = 0xffffffffu, ej = 0u, ch = 0u;
#pragma unroll
        for (int w = 0; w < W; ++w) {
            const int o = ro[w];
            const bool port_ok = (unsigned)o < (unsigned)P;
            const unsigned ob = port_ok ? (unsigned)o : NO_PORT;
            const unsigned sh = 8 * (w & 3);
            if (w < 4) lo = (lo & ~(0xffu << sh)) | (ob << sh);
            else hi = (hi & ~(0xffu << sh)) | (ob << sh);
            const bool valid = req & (w < cnt[j]);
            const bool e = re[w] != 0, sp = rp[w] != 0;
            ej |= (unsigned)(valid & e) << w;
            ch |= (unsigned)(valid & !e & sp & port_ok) << w;
        }
        outw[j] = make_uint2(lo, hi);
        wej[j] = ej;
        wch[j] = ch;
    }

    int budget = p_budget;
    unsigned granted = 0u;              // bit j: request row j granted
    int cs[NJ], es[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) cs[j] = es[j] = -1;
    const int np32 = (P + 31) / 32;

#pragma unroll
    for (int w = 0; w < W; ++w) {
        // ---- ejection grants.  X(k), the number of requests below k
        // that want to eject, from ballots: a lane's row prefix plus the
        // earlier rows' totals.  Net queues come first, so X counts the
        // net prefix cn(k) for k < PV and sn + the source prefix above.
        unsigned ball[NJ];
        int X[NJ], tot = 0;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const bool m = (((granted >> j) & 1u) == 0u)
                           & (((wej[j] >> w) & 1u) != 0u);
            ball[j] = __ballot_sync(0xffffffffu, m);
            X[j] = tot + __popc(ball[j] & lt);
            tot += __popc(ball[j]);
        }
        const int x_rot = prefix_at(X, s_rot, tot);   // cn(s_rot)
        const int sn = prefix_at(X, PV, tot);         // net total
        const int ss = tot - sn;
        int n_grant = 0;
        unsigned g_ej = 0u;             // bit j: granted an ejection now
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int k = lane + 32 * j;
            const int rank = k < PV
                ? X[j] - x_rot + (k < s_rot ? sn : 0) + (net_first ? 0 : ss)
                : X[j] - sn + (net_first ? sn : 0);
            const bool g = (((ball[j] >> lane) & 1u) != 0u) & (rank < budget);
            n_grant += __popc(__ballot_sync(0xffffffffu, g));
            es[j] = g ? w : es[j];
            g_ej |= (unsigned)g << j;
        }
        budget -= n_grant;

        // ---- channel grants: least packed priority per output port
#pragma unroll 1
        for (int p = lane; p < P; p += 32) cmin[p] = INT_MAX;
        __syncwarp();
        int cmb[NJ], port[NJ];          // cmb = -1: not live
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int k = lane + 32 * j;
            const unsigned o = ((w < 4 ? outw[j].x : outw[j].y)
                                >> (8 * (w & 3))) & 0xffu;
            port[j] = (int)o;
            // valid at the start of the round (the round's ejection
            // grants all have ej set, so they never want a channel).
            // Every lane reads and updates unconditionally (a lane that
            // is not live hits its own spare slot), so nothing branches.
            const unsigned tk = taken[o >> 5];
            const bool live = (((granted >> j) & 1u) == 0u)
                              & (((wch[j] >> w) & 1u) != 0u)
                              & (((tk >> (o & 31)) & 1u) == 0u);
            cmb[j] = live ? rot[j] * KSHIFT + k : -1;
            atomicMin(&cmin[live ? (int)o : KSHIFT + lane], cmb[j]);
            rot[j] += step;             // next round's, without a %
            if (rot[j] >= R) rot[j] -= R;
        }
        granted |= g_ej;
        __syncwarp();
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const bool win = (cmb[j] >= 0) & (cmin[port[j]] == cmb[j]);
            cs[j] = win ? w : cs[j];
            granted |= (unsigned)win << j;
        }
#pragma unroll 1
        for (int g = 0; g < np32; ++g) {
            const int p = 32 * g + lane;
            const int c = p < P ? cmin[p] : INT_MAX;
            const bool won = c != INT_MAX;
            const unsigned wb = __ballot_sync(0xffffffffu, won);
            if (won) win_req[(size_t)r * P + p] = c % KSHIFT;
            if (lane == 0) taken[g] |= wb;
        }
        __syncwarp();                   // taken and cmin, next round
    }

    // ports never won keep -1
    for (int g = 0; g < np32; ++g) {
        const int p = 32 * g + lane;
        if (p < P && !((taken[g] >> lane) & 1u))
            win_req[(size_t)r * P + p] = -1;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int k = lane + 32 * j;
        if (k < K) {
            if (k < PV) {
                cs_n[(size_t)r * PV + k] = cs[j];
                es_n[(size_t)r * PV + k] = es[j];
            } else {
                cs_s[(size_t)r * PE + (k - PV)] = cs[j];
                es_s[(size_t)r * PE + (k - PV)] = es[j];
            }
        }
    }
}

template <int W, int NJ>
int launch_wj(const int* cyc, int cyc_stride, const int* out_n,
              const int* ej_n, const int* sp_n, const int* cnt_n, const int* out_s, const int* ej_s,
              const int* sp_s, const int* cnt_s, const int* epr, int* cs_n,
              int* es_n, int* cs_s, int* es_s, int* win_req, int L, int N,
              int P, int V, int PE, int p_budget, int NQ, int R,
              cudaStream_t stream) {
    const int smem = RPB * warp_ints(P * V, PE, W) * (int)sizeof(int);
    // the attribute belongs to the current device: set it on every launch
    cudaError_t e = cudaFuncSetAttribute(
        alloc_kernel<W, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((N + RPB - 1) / RPB, L);
    alloc_kernel<W, NJ><<<grid, NT, smem, stream>>>(
        cyc, cyc_stride, out_n, ej_n, sp_n, cnt_n, out_s, ej_s, sp_s, cnt_s, epr,
        cs_n, es_n, cs_s, es_s, win_req, N, P, V, PE, p_budget, NQ, R);
    return (int)cudaGetLastError();
}

template <int W>
int launch_w(int nj, const int* cyc, int cyc_stride, const int* out_n, const int* ej_n,
             const int* sp_n, const int* cnt_n, const int* out_s,
             const int* ej_s, const int* sp_s, const int* cnt_s,
             const int* epr, int* cs_n, int* es_n, int* cs_s, int* es_s,
             int* win_req, int L, int N, int P, int V, int PE, int p_budget,
             int NQ, int R, cudaStream_t st) {
#define ALLOC_NJ(J)                                                         \
    case J:                                                                 \
        return launch_wj<W, J>(cyc, cyc_stride, out_n, ej_n, sp_n, cnt_n,    \
                               out_s, ej_s, sp_s, cnt_s, epr, cs_n, es_n,    \
                               cs_s, es_s, win_req, L, N, P, V, PE,          \
                               p_budget, NQ, R, st);
    switch (nj) {
        ALLOC_NJ(1) ALLOC_NJ(2) ALLOC_NJ(3) ALLOC_NJ(4)
        ALLOC_NJ(5) ALLOC_NJ(6) ALLOC_NJ(7) ALLOC_NJ(8)
    }
#undef ALLOC_NJ
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches one warp per router (four per block) and lane (grid y) on
// `stream`; returns the launch's cudaError_t (0 = success).  Shapes as in
// the header; W must be 1..8; the caller checks dtype, shape, contiguity,
// the device and every lane's cycle (0 <= cycle, cycle*7919 + R + W*131 <
// 2^31).
extern "C" int alloc_rounds_launch(
        const int* cyc, int cyc_stride, const int* out_n, const int* ej_n, const int* sp_n,
        const int* cnt_n, const int* out_s, const int* ej_s,
        const int* sp_s, const int* cnt_s, const int* epr,
        int* cs_n, int* es_n, int* cs_s, int* es_s, int* win_req,
        int L, int N, int W, int P, int V, int PE, int p_budget, int NQ,
        int R, void* stream) {
    if (L <= 0 || L > 65535 || N <= 0 || W <= 0 || W > 8 || P <= 0
        || V <= 0 || PE < 0 || R <= 0 || P * V + PE >= KSHIFT
        || cyc_stride < 0 || cyc_stride > 1)
        return (int)cudaErrorInvalidValue;
    const int nj = (P * V + PE + 31) / 32;
    cudaStream_t st = (cudaStream_t)stream;
#define ALLOC_W(WW)                                                        \
    case WW:                                                               \
        return launch_w<WW>(nj, cyc, cyc_stride, out_n, ej_n, sp_n, cnt_n, \
                            out_s, ej_s, sp_s, cnt_s, epr, cs_n, es_n,     \
                            cs_s, es_s, win_req, L, N, P, V, PE, p_budget, \
                            NQ, R, st);
    switch (W) {
        ALLOC_W(1) ALLOC_W(2) ALLOC_W(3) ALLOC_W(4)
        ALLOC_W(5) ALLOC_W(6) ALLOC_W(7) ALLOC_W(8)
    }
#undef ALLOC_W
    return (int)cudaErrorInvalidValue;
}
