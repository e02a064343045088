// W-round rotating-priority switch allocation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `alloc_rounds_pallas` (body
// `_alloc_kernel`) of src/repro/kernels/alloc.py, whose math is
// `_alloc_rounds_math` in src/repro/kernels/ref.py.  It runs once in
// every simulated cycle of the flit engine (SwitchCore.alloc).
//
// Contract (int32 everywhere; N routers, PV = P*V network queues and PE
// source queues per router, K = PV + PE < KSHIFT requests):
//   in   out_n/ej_n/sp_n [N, PV, W], cnt_n [N, PV],
//        out_s/ej_s/sp_s [N, PE, W], cnt_s [N, PE], epr [N]
//   out  cs_n/es_n [N, PV], cs_s/es_s [N, PE]  granted window offset by
//        kind (-1 = none); win_req [N, P] winning request per output port
// Each round w: ejection grants go to the requests ranked below the
// router's remaining budget of p ejection ports, ranked by rotated
// exclusive prefix counts (net queues from column cycle % PV, before or
// after the source queues by cycle parity); then each output port grants
// the live request with the least ((qidx + cycle*7919 + w*131) mod R)
// * 256 + k.
//
// Bound on this card.  The work per router is a few hundred integer
// operations per round; the call is bound by its bytes: at q=19 it reads
// ~4.9 MB and writes ~0.9 MB, ~1.7 us at 3.35 TB/s, so launch latency
// (a few us) dominates.
//
// Design.  One block of 256 threads per router, one thread per request
// (K <= 255 is guaranteed by KSHIFT).  A round's ejection ranks are two
// block-wide exclusive prefix sums (warp shuffles, then the 8 warp
// totals from shared memory), one over the net queues and one over the
// source queues; the grant count comes from __syncthreads_count.  The
// channel winner of each output port is a shared-memory atomicMin of the
// packed priority: min does not depend on the order of the atomics, and
// the packed values are distinct, so the result is deterministic, and
// `cmb == cmin[out]` names exactly one winner.  Every modulo operand is
// non-negative (cycle <= 200k keeps cycle*7919 + qidx + w*131 below
// 2^31; rows with epr = -1 still have qidx = NQ - PE + k >= 0 and are
// masked by cnt_s == 0), so C's % equals jnp's floor-mod, and the
// result is bit-exact against the plain version.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int KSHIFT = 256;
constexpr int NT = 256;
constexpr int NWARP = NT / 32;

// Block-wide exclusive prefix sums of two int lanes at once; `tot`
// receives both block totals.  Every thread of the block must call it.
__device__ __forceinline__ int2 block_scan2(int2 v, int2* warp_tot,
                                            int2* tot) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int2 inc = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, inc.x, off);
        const int y = __shfl_up_sync(0xffffffffu, inc.y, off);
        if (lane >= off) {
            inc.x += x;
            inc.y += y;
        }
    }
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    int2 pre = make_int2(0, 0), all = make_int2(0, 0);
#pragma unroll
    for (int i = 0; i < NWARP; ++i) {
        const int2 t = warp_tot[i];
        if (i < warp) {
            pre.x += t.x;
            pre.y += t.y;
        }
        all.x += t.x;
        all.y += t.y;
    }
    __syncthreads();                 // warp_tot is rewritten next round
    *tot = all;
    return make_int2(pre.x + inc.x - v.x, pre.y + inc.y - v.y);
}

__global__ void __launch_bounds__(NT)
alloc_kernel(int cycle,
             const int* __restrict__ out_n, const int* __restrict__ ej_n,
             const int* __restrict__ sp_n, const int* __restrict__ cnt_n,
             const int* __restrict__ out_s, const int* __restrict__ ej_s,
             const int* __restrict__ sp_s, const int* __restrict__ cnt_s,
             const int* __restrict__ epr,
             int* __restrict__ cs_n, int* __restrict__ es_n,
             int* __restrict__ cs_s, int* __restrict__ es_s,
             int* __restrict__ win_req,
             int W, int P, int V, int PE, int p_budget, int NQ, int R) {
    __shared__ int cmin[KSHIFT];     // per output port, this round
    __shared__ int taken[KSHIFT];    // output port granted in a past round
    __shared__ int cn_sh[KSHIFT];    // net-queue exclusive prefix counts
    __shared__ int2 warp_tot[NWARP];

    const int r = blockIdx.x;
    const int k = threadIdx.x;
    const int PV = P * V;
    const int K = PV + PE;
    const bool is_req = k < K;
    const bool is_net = k < PV;

    // this thread's request: its W-slot rows, depth and global queue id
    const int* outp = nullptr;
    const int* ejp = nullptr;
    const int* spp = nullptr;
    int cnt = 0, qidx = 0;
    if (is_net) {
        const size_t row = (size_t)r * PV + k;
        outp = out_n + row * W;
        ejp = ej_n + row * W;
        spp = sp_n + row * W;
        cnt = cnt_n[row];
        qidx = r * PV + k;
    } else if (is_req) {
        const int ks = k - PV;
        const size_t row = (size_t)r * PE + ks;
        outp = out_s + row * W;
        ejp = ej_s + row * W;
        spp = sp_s + row * W;
        cnt = cnt_s[row];
        qidx = NQ + epr[r] * PE + ks;
    }
    const int s_rot = cycle % PV;
    const bool net_first = (cycle % 2) == 0;
    const int rot0 = (qidx + cycle * 7919) % R;

    if (k < P) taken[k] = 0;
    int budget = p_budget;
    bool granted = false;
    int cs = -1, es = -1, wr = -1;

    for (int w = 0; w < W; ++w) {
        bool v = false, ej = false, sp = false;
        int out = -1;
        if (is_req) {
            v = cnt > w && !granted;
            ej = ejp[w] != 0;
            sp = spp[w] != 0;
            out = outp[w];
        }

        // ---- ejection grants: rotated exclusive-prefix ranks
        const int m = (v && ej) ? 1 : 0;
        int2 tot;
        const int2 ex = block_scan2(
            make_int2(is_net ? m : 0, (is_req && !is_net) ? m : 0),
            warp_tot, &tot);
        if (is_net) cn_sh[k] = ex.x;
        if (k < P) cmin[k] = INT_MAX;
        __syncthreads();
        const int sn = tot.x, ss = tot.y;
        bool g_ej = false;
        if (m) {
            int rank;
            if (is_net) {
                rank = ex.x - cn_sh[s_rot] + (k < s_rot ? sn : 0)
                       + (net_first ? 0 : ss);
            } else {
                rank = ex.y + (net_first ? sn : 0);
            }
            g_ej = rank < budget;
        }
        budget -= __syncthreads_count(g_ej);

        // ---- channel grants: least packed priority per output port
        const bool elig = v && !ej && sp;
        const int cmb = ((rot0 + w * 131) % R) * KSHIFT + k;
        const bool live = elig && out >= 0 && out < P && !taken[out];
        if (live) atomicMin(&cmin[out], cmb);
        __syncthreads();
        const bool win = live && cmin[out] == cmb;
        if (k < P && cmin[k] != INT_MAX) {
            taken[k] = 1;
            wr = cmin[k] % KSHIFT;
        }
        granted = granted || win || g_ej;
        if (win) cs = w;
        if (g_ej) es = w;
        __syncthreads();             // cmin is reset next round
    }

    if (is_net) {
        const size_t row = (size_t)r * PV + k;
        cs_n[row] = cs;
        es_n[row] = es;
    } else if (is_req) {
        const size_t row = (size_t)r * PE + (k - PV);
        cs_s[row] = cs;
        es_s[row] = es;
    }
    if (k < P) win_req[(size_t)r * P + k] = wr;
}

}  // namespace

// Launches one block per router on `stream`; returns the launch's
// cudaError_t (0 = success).  Shapes as in the header; the caller checks
// dtype, shape, contiguity and device.
extern "C" int alloc_rounds_launch(
        int cycle, const int* out_n, const int* ej_n, const int* sp_n,
        const int* cnt_n, const int* out_s, const int* ej_s,
        const int* sp_s, const int* cnt_s, const int* epr,
        int* cs_n, int* es_n, int* cs_s, int* es_s, int* win_req,
        int N, int W, int P, int V, int PE, int p_budget, int NQ, int R,
        void* stream) {
    if (N <= 0 || W <= 0 || P <= 0 || V <= 0 || PE < 0 || R <= 0 ||
        P * V + PE >= KSHIFT || cycle < 0)
        return (int)cudaErrorInvalidValue;
    alloc_kernel<<<N, NT, 0, (cudaStream_t)stream>>>(
        cycle, out_n, ej_n, sp_n, cnt_n, out_s, ej_s, sp_s, cnt_s, epr,
        cs_n, es_n, cs_s, es_s, win_req, W, P, V, PE, p_budget, NQ, R);
    return (int)cudaGetLastError();
}
