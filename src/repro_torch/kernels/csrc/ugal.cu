// UGAL route choice and UGAL/VAL candidate selection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ugal_select_pallas` (body
// `_ugal_kernel`) of src/repro/kernels/alloc.py, whose math is
// `_ugal_score_math` in src/repro/kernels/ref.py.  Two kernels share the
// score:
//
// * `ugal_route_kernel` (main path): the whole UGAL branch of
//   SwitchCore.route_decision in one launch per simulated cycle, from the
//   raw candidate draws to (inter, phase).  Plain version:
//   repro_torch.kernels.ref.ugal_route_ref.
// * `ugal_kernel`: the TPU kernel's own contract (lengths and occupancy
//   terms in, first-argmin out), kept and held against
//   `ugal_select_ref`, off the main path.
//
// ugal_route contract (L lanes, E endpoints, C >= 1 candidates, N < 2^15
// routers, P ports):
//   in   src_r [E] int32             source routers (every lane)
//        dst_r [L, E] int32          destination routers
//        cands [L, E, C] int32       raw draws in [0, N), not yet bumped
//        dist, port_toward [N, N]    int16 tables (port -1: none), shared
//                                    by the lanes, or [L, N, N] stacked
//        nbr [N, P] (or [L, N, P])   neighbour (-1: dead or pad port)
//        occ [L, N, P] int32         downstream depth (may hold BIG)
//   out  inter, phase [L, E] int32
// The L E endpoints of all lanes are indexed together (lane = e / E), so
// a sweep's route choice is one launch; each lane reads its own occupancy
// and tables, and equals a single-lane call (L = 1).
// Per endpoint: each candidate equal to the source or the destination is
// bumped by 1, then by 2 (mod N); MIN's and each candidate's path length
// (dist widened to int32 before the add) and occupancy term are gathered
// -- UGAL-L: the first hop's occupancy, capped at occ_cap; UGAL-G: the
// capped occupancies along the MIN path of each leg, two hops where the
// leg is >= 2 long, with a dead first hop's router -1 read as N - 1 (the
// reference's wrap of a negative index, met on stale tables) -- scored
// as in `score`, and the first minimum over [MIN, cand_0..] wins, so ties
// go to MIN.  inter = dst or the winning candidate, phase = (MIN won).
//
// Bound on this card.  A few integer operations per path; the work is
// gathers.  At q=19 (E = 10,830, C = 4) the call reads src_r, dst_r and
// cands (259,920 B), writes inter and phase (86,640 B) and gathers per
// endpoint, UGAL-L: 9 dist and 5 port_toward entries (int16) and 5 occ
// entries (int32), 48 B, 519,840 B in all -- 0.87 MB, 0.26 us at
// 3.35 TB/s; UGAL-G: 9 legs of dist, port_toward, nbr and occ plus, on a
// two-hop leg, the second router's port_toward and occ, up to 162 B,
// 2.10 MB in all, 0.63 us.  (chip_smoke.py counts the bytes of its own
// inputs.)  Either bound is far below a launch's fixed cost, which
// `ugal_empty_kernel` measures: the gain of the fusion is the 55 (UGAL-L)
// to 161 (UGAL-G) device operations per cycle -- and their host
// dispatches -- that the gathers took in plain PyTorch.
//
// Design.  One 8-lane group of a warp per endpoint, one lane per path
// (lane 0: MIN; lane j: candidate j - 1; for C > 7 a lane walks paths j,
// j + 8, ...).  UGAL-G's four dependent gathers per leg run on ~54k
// threads at q=19 instead of one thread per endpoint, and the int16
// tables (1.04 MB each) stay in the 50 MB L2, read through the read-only
// path.  The first-argmin is a shuffle reduction of (score, index, inter)
// that prefers the lower index on equal scores.  No shared memory, no
// atomics.
//
// The UGAL-L product is taken as a uint32 multiply and read back as
// int32: signed overflow is undefined in C++, and the unsigned product is
// the two's-complement wrap that the reference's int32 multiply gives
// (dead paths reach len 2^15 with occupancies up to 2^20; their wrapped
// product is masked to `big` afterwards, in the reference's order).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;           // ugal_select: threads per block
constexpr int RT = 128;           // ugal_route: threads per block
constexpr int LANES = 8;          // ugal_route: lanes per endpoint
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int score(int len, int occ, bool ugal_g,
                                     int unreach, int big) {
    if (len >= unreach) return big;
    const unsigned int l = (unsigned int)len, o = (unsigned int)occ;
    return (int)(ugal_g ? o + l : l * o);
}

__global__ void __launch_bounds__(NT)
ugal_kernel(const int* __restrict__ len_min, const int* __restrict__ len_val,
            const int* __restrict__ occ_min, const int* __restrict__ occ_val,
            int* __restrict__ best, int E, int C, bool ugal_g, int unreach,
            int big) {
    const int e = blockIdx.x * NT + threadIdx.x;
    if (e >= E) return;
    int best_s = score(len_min[e], occ_min[e], ugal_g, unreach, big);
    int best_i = 0;
    const size_t row = (size_t)e * C;
    for (int c = 0; c < C; ++c) {
        const int s = score(len_val[row + c], occ_val[row + c], ugal_g,
                            unreach, big);
        if (s < best_s) {
            best_s = s;
            best_i = c + 1;
        }
    }
    best[e] = best_i;
}

// one lane's tables, as the route kernel reads them
struct Tables {
    const short* __restrict__ dist;          // [N, N]
    const short* __restrict__ port_toward;   // [N, N]
    const int* __restrict__ nbr;             // [N, P]
    const int* __restrict__ occ;             // [N, P]
    int N, P, occ_cap;
};

__device__ __forceinline__ int dist32(const Tables& t, int s, int d) {
    return (int)__ldg(t.dist + (size_t)s * t.N + d);
}

__device__ __forceinline__ int port(const Tables& t, int s, int d) {
    return (int)__ldg(t.port_toward + (size_t)s * t.N + d);
}

// capped occupancy of router s's port o (0 where there is no port)
__device__ __forceinline__ int occ_at(const Tables& t, int s, int o) {
    return o >= 0 ? min(__ldg(t.occ + (size_t)s * t.P + o), t.occ_cap) : 0;
}

// occupancy sum along the MIN path s -> d of length len (D <= 2 form)
__device__ __forceinline__ int path_occ(const Tables& t, int s, int d,
                                        int len) {
    const int o1 = port(t, s, d);
    int r = occ_at(t, s, o1);
    if (len >= 2) {
        int m = __ldg(t.nbr + (size_t)s * t.P + max(o1, 0));
        if (m < 0) m += t.N;          // stale table: a dead first hop
        r += occ_at(t, m, port(t, m, d));
    }
    return r;
}

__global__ void __launch_bounds__(RT)
ugal_route_kernel(const int* __restrict__ src_r, const int* __restrict__ dst_r,
                  const int* __restrict__ cands, Tables t, bool stacked,
                  int* __restrict__ inter, int* __restrict__ phase, int L,
                  int E, int C, bool ugal_g, int unreach, int big) {
    // e indexes the endpoints of every sweep lane: lane sl = e / E
    const long long e = (long long)blockIdx.x * (RT / LANES)
                        + threadIdx.x / LANES;
    const int lane = threadIdx.x % LANES;
    // lanes without a path keep (INT_MAX, INT_MAX) and lose every
    // comparison; a lane's first path is taken whatever its score
    int best_s = INT_MAX, best_i = INT_MAX, best_v = 0;
    if (e < (long long)L * E) {
        const int sl = (int)(e / E);
        const size_t nn = stacked ? (size_t)sl * t.N * t.N : 0;
        const size_t np = (size_t)sl * t.N * t.P;
        t.dist += nn;
        t.port_toward += nn;
        t.nbr += stacked ? np : 0;
        t.occ += np;
        const int s = __ldg(src_r + (e - (long long)sl * E));
        const int d = __ldg(dst_r + e);
        for (int j = lane; j <= C; j += LANES) {
            int v, len, oc;
            if (j == 0) {
                v = d;
                len = dist32(t, s, d);
                oc = ugal_g ? path_occ(t, s, d, len) : occ_at(t, s, port(t, s, d));
            } else {
                v = __ldg(cands + (size_t)e * C + (j - 1));
                if (v == s || v == d) v = (v + 1) % t.N;
                if (v == s || v == d) v = (v + 2) % t.N;
                const int l1 = dist32(t, s, v), l2 = dist32(t, v, d);
                len = l1 + l2;
                oc = ugal_g ? path_occ(t, s, v, l1) + path_occ(t, v, d, l2)
                            : occ_at(t, s, port(t, s, v));
            }
            const int sc = score(len, oc, ugal_g, unreach, big);
            if (j == lane || sc < best_s) {
                best_s = sc;
                best_i = j;
                best_v = v;
            }
        }
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) {
        const int os = __shfl_xor_sync(FULL, best_s, off, LANES);
        const int oi = __shfl_xor_sync(FULL, best_i, off, LANES);
        const int ov = __shfl_xor_sync(FULL, best_v, off, LANES);
        if (os < best_s || (os == best_s && oi < best_i)) {
            best_s = os;
            best_i = oi;
            best_v = ov;
        }
    }
    if (e < (long long)L * E && lane == 0) {
        inter[e] = best_v;
        phase[e] = best_i == 0;
    }
}

__global__ void ugal_empty_kernel() {}

}  // namespace

// Launches ceil(E / 256) blocks on `stream`; returns the launch's
// cudaError_t (0 = success).  Shapes as in the header; the caller checks
// dtype, shape, contiguity and device.
extern "C" int ugal_select_launch(
        const int* len_min, const int* len_val, const int* occ_min,
        const int* occ_val, int* best, int E, int C, int ugal_g,
        int unreach, int big, void* stream) {
    if (E < 0 || C < 0) return (int)cudaErrorInvalidValue;
    if (E == 0) return 0;
    const int blocks = (E + NT - 1) / NT;
    ugal_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
        len_min, len_val, occ_min, occ_val, best, E, C, ugal_g != 0,
        unreach, big);
    return (int)cudaGetLastError();
}

// Launches ceil(L E / 16) blocks of 128 threads (8 lanes per endpoint) on
// `stream`; returns the launch's cudaError_t (0 = success).  Contract as
// in the header (stacked != 0: [L, ...] tables); the caller checks
// dtypes, shapes, contiguity, the device, E >= 1, C >= 1 and N < 2^15.
extern "C" int ugal_route_launch(
        const int* src_r, const int* dst_r, const int* cands,
        const short* dist, const short* port_toward, const int* nbr,
        const int* occ, int* inter, int* phase, int L, int E, int C, int N,
        int P, int stacked, int ugal_g, int unreach, int big, int occ_cap,
        void* stream) {
    if (L < 1 || E < 1 || C < 1 || N < 1 || N >= (1 << 15) || P < 1)
        return (int)cudaErrorInvalidValue;
    const Tables t{dist, port_toward, nbr, occ, N, P, occ_cap};
    const long long blocks = ((long long)L * E * LANES + RT - 1) / RT;
    ugal_route_kernel<<<(unsigned)blocks, RT, 0, (cudaStream_t)stream>>>(
        src_r, dst_r, cands, t, stacked != 0, inter, phase, L, E, C,
        ugal_g != 0, unreach, big);
    return (int)cudaGetLastError();
}

// One block of one warp that does nothing: the fixed cost of a launch,
// the floor under both kernels above.
extern "C" int ugal_empty_launch(void* stream) {
    ugal_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
