// UGAL/VAL candidate selection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ugal_select_pallas` (body
// `_ugal_kernel`) of src/repro/kernels/alloc.py, whose math is
// `_ugal_score_math` in src/repro/kernels/ref.py.  It runs at every
// injection under UGAL-L and UGAL-G (SwitchCore.route_decision), once per
// simulated cycle, open and closed loop.
//
// Contract (int32 everywhere; E endpoints, C Valiant candidates):
//   in   len_min, occ_min [E]      MIN path length and occupancy term
//        len_val, occ_val [E, C]   the candidates' (row-major)
//   out  best [E]                  index into [MIN, cand_0..cand_{C-1}]
// UGAL-L scores len * occ, UGAL-G scores occ + len; a path with
// len >= unreach is dead and scores `big`.  best is the FIRST minimum,
// so ties go to MIN (index 0).
//
// Bound on this card.  A few integer operations per candidate; the call
// is bound by its bytes: at q=19 (E = 10,830, C = 4) it reads 433,200 B
// and writes 43,320 B, 0.14 us at 3.35 TB/s, so launch latency dominates.
//
// Design.  One thread per endpoint walks its C candidates in order and
// keeps the running minimum with a strict `<`, which is the first-minimum
// rule.  The UGAL-L product is taken as a uint32 multiply and read back as
// int32: signed overflow is undefined in C++, and the unsigned product is
// the two's-complement wrap that the reference's int32 multiply gives
// (dead paths reach len 2^15 with occupancies up to 2^20; their wrapped
// product is masked to `big` afterwards, in the reference's order).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

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
