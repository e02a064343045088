// The ECMP choice of the flit engine for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference computes this choice in jnp
// inside `SwitchCore._desires` (src/repro/sim/engine.py:386-391: a gather
// of each slot's equal-cost row, its occupancies, an argmin and a gather
// back).  It became a kernel because that chain was 70% of the device
// time of a fat-tree cycle (FT-3 p=22 under ECMP) in plain PyTorch, which
// builds [slots, M] arrays of ports, indices and scores (~3.4 GB at five
// lanes) to keep one port per slot.  It runs twice in every cycle on
// tables with equal-cost sets (the network window and the source window).
// Plain version: repro_torch.kernels.ref.ecmp_port_ref.
//
// Contract (n slots, table rows [n_rows, M] int16, -1 padded, the pads
// trailing as SimTables.build and SimTables.stack lay them out; occ the
// lane-flattened credit view, P ports per state row):
//   in   rows [n_rows, M] int16    equal-cost ports of (router, target) row
//                                  router * N + target
//        router [r_mod], state [s_mod] int32   table rows and state rows;
//                                  slot s reads router[(s / r_div) % r_mod]
//                                  and state[(s / s_div) % s_mod] (the
//                                  wrapper's broadcast of [L, N, 1, 1, 1]
//                                  rows against [L, N, P, V, W] targets,
//                                  or [L, n_ep, 1] against [L, n_ep, W])
//        tgt [n] int32             target router of each slot
//        occ [.., P] int32         depth behind each port (BIG: dead)
//   out  port [n] int32            the first least-occupied port of the
//                                  slot's row, in row order; -1 for an
//                                  empty row (and for a row index outside
//                                  the table, where the plain version
//                                  raises)
// A pad scores `big`, as does a dead port through occ; the first minimum
// wins (jnp.argmin's tie rule), so an all-`big` row gives its first entry.
//
// Bound on this card (sfbench/roofline.py::ecmp_bytes): each slot's
// target read and port written (8 B), each distinct (router, target) row
// read once (88 B at M = 44) and the credit view once.  At FT-3 p=22 with
// five lanes a cycle's two calls cover 7,986,000 slots: 64 MB of targets
// and ports, ~12 MB of distinct rows and 2.6 MB of credit view, 23 us at
// 3.35 TB/s.
//
// Design.  One thread per slot over a grid-stride loop.  The router rows
// come from the slot index by a division and a modulo, so no [slots]
// index array exists.  Each row is read through the read-only path in
// 8-byte vectors where M and the table allow it (88-byte rows at p=22),
// and the scan stops after the row's first pad: every later entry is a
// pad too, scores `big` and never beats the first pad, so the early stop
// leaves the first minimum as it is while a width-1 row costs one load.
// The occupancies of a slot's router (176 B at p=22) are shared by the
// ~1,000 slots of its window and stay in L1/L2.  A strict `<` keeps the
// first minimum.  No shared memory, no atomics.  (Four threads per slot
// with a shuffle reduction measured 2.2x slower at p=22: most rows are
// 1 or 22 wide, so the extra threads mostly read pads.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;           // threads per block

template <int VEC>
struct Row;

template <>
struct Row<4> {                   // 4 ports in one 8-byte load
    static __device__ __forceinline__ void load(const short* p, int c,
                                                int (&e)[4]) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + c);
        e[0] = (short)(v.x & 0xffffu);
        e[1] = (short)(v.x >> 16);
        e[2] = (short)(v.y & 0xffffu);
        e[3] = (short)(v.y >> 16);
    }
};

template <>
struct Row<2> {
    static __device__ __forceinline__ void load(const short* p, int c,
                                                int (&e)[2]) {
        const unsigned v = __ldg(reinterpret_cast<const unsigned*>(p) + c);
        e[0] = (short)(v & 0xffffu);
        e[1] = (short)(v >> 16);
    }
};

template <>
struct Row<1> {
    static __device__ __forceinline__ void load(const short* p, int c,
                                                int (&e)[1]) {
        e[0] = __ldg(p + c);
    }
};

template <int VEC>
__global__ void __launch_bounds__(NT)
ecmp_kernel(const short* __restrict__ rows, const int* __restrict__ router,
            const int* __restrict__ state, const int* __restrict__ tgt,
            const int* __restrict__ occ, int* __restrict__ out, unsigned n,
            unsigned r_div, unsigned r_mod, unsigned s_div, unsigned s_mod,
            long long n_rows, int M, int N, int P, int big) {
    const int chunks = M / VEC;
    for (unsigned s = blockIdx.x * NT + threadIdx.x; s < n;
         s += gridDim.x * NT) {
        const long long row =
            (long long)__ldg(router + (s / r_div) % r_mod) * N
            + __ldg(tgt + s);
        int best = -1;
        if (row >= 0 && row < n_rows) {
            const short* p = rows + row * M;
            const int* o = occ + (long long)__ldg(state + (s / s_div) % s_mod)
                                 * P;
            int best_s = 0;
            for (int c = 0; c < chunks; ++c) {
                int e[VEC];
                Row<VEC>::load(p, c, e);
                bool pad = false;
#pragma unroll
                for (int j = 0; j < VEC; ++j) {
                    const int sc = e[j] < 0 ? big : __ldg(o + e[j]);
                    if ((c | j) == 0 || sc < best_s) {
                        best_s = sc;
                        best = e[j];
                    }
                    if (e[j] < 0) {
                        pad = true;
                        break;
                    }
                }
                if (pad) break;
            }
        }
        out[s] = best;
    }
}

template <int VEC>
int launch(const short* rows, const int* router, const int* state,
           const int* tgt, const int* occ, int* out, unsigned n,
           unsigned r_div, unsigned r_mod, unsigned s_div, unsigned s_mod,
           long long n_rows, int M, int N, int P, int big,
           cudaStream_t stream) {
    const long long want = ((long long)n + NT - 1) / NT;
    const unsigned blocks = (unsigned)(want < (1 << 16) ? want : (1 << 16));
    ecmp_kernel<VEC><<<blocks, NT, 0, stream>>>(
        rows, router, state, tgt, occ, out, n, r_div, r_mod, s_div, s_mod,
        n_rows, M, N, P, big);
    return (int)cudaGetLastError();
}

}  // namespace

// Launches the choice for n slots on `stream`; returns the launch's
// cudaError_t (0 = success).  Contract as in the header; the caller
// checks dtypes, shapes, contiguity and the device.
extern "C" int ecmp_port_launch(
        const short* rows, const int* router, const int* state,
        const int* tgt, const int* occ, int* out, long long n, int r_div,
        int r_mod, int s_div, int s_mod, long long n_rows, int M, int N,
        int P, int big, void* stream) {
    if (n == 0) return 0;
    if (n < 0 || n >= (1LL << 31) || r_div < 1 || r_mod < 1 || s_div < 1
        || s_mod < 1 || n_rows < 0 || M < 1 || N < 1 || P < 1)
        return (int)cudaErrorInvalidValue;
    // the widest load that every row start allows
    const uintptr_t at = (uintptr_t)rows;
    const unsigned un = (unsigned)n;
    const cudaStream_t st = (cudaStream_t)stream;
    if (M % 4 == 0 && at % 8 == 0)
        return launch<4>(rows, router, state, tgt, occ, out, un, r_div,
                         r_mod, s_div, s_mod, n_rows, M, N, P, big, st);
    if (M % 2 == 0 && at % 4 == 0)
        return launch<2>(rows, router, state, tgt, occ, out, un, r_div,
                         r_mod, s_div, s_mod, n_rows, M, N, P, big, st);
    return launch<1>(rows, router, state, tgt, occ, out, un, r_div, r_mod,
                     s_div, s_mod, n_rows, M, N, P, big, st);
}
