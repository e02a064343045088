// Batched (min,+) matrix product for Hopper (sm_90a).
//
//   C[b, i, j] = min( min_k A[b, i, k] + B[b, k, j], 3e38 )
//
// Replaces the Pallas TPU kernel `minplus_pallas` (body `_minplus_kernel`)
// of src/repro/kernels/minplus.py, which builds every routing table by
// (min,+) squaring of the seeded distance matrix (APSP).
//
// Bound on this card.  No tensor core evaluates a (min,+) contraction,
// so the work runs on the CUDA cores: one FADD and one FMNMX per
// (b, i, j, k), i.e. 2*B*M*N*K instructions over 132 SMs x 128 fp32
// lanes.  At q=19 (722^3) that is ~22 us per squaring at 1.98 GHz; the
// bytes (2 MB in, 2 MB out) take ~1.2 us, so the kernel is bound by
// operations, not memory.
//
// Design.  One block of 256 threads computes a 64x64 output tile; each
// thread keeps a 4x4 register micro-tile, initialised to 3e38.  Tiles of
// A (64x16) and B (16x64) are staged in shared memory, so every element
// loaded from global memory feeds 64 (add, min) pairs from registers.
// Thread (ty, tx) owns rows ty + 16*i and columns tx + 16*j, so the
// shared-memory reads of a warp are broadcasts (A) or consecutive words
// (B), free of bank conflicts, and the final stores are coalesced.  The
// ragged edge is masked on load with 3e38 (3e38 + 3e38 = inf, which the
// min then ignores); the result is saturated to 3e38 at the end, as the
// TPU kernel does.  Distances are small integers, so the result is
// bit-exact against the plain version (repro_torch.kernels.ref).  wgmma,
// TMA and a deeper pipeline are later work.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int NT = 256;          // (BM / TM) * (BN / TN) threads
constexpr float BIG = 3.0e38f;

__global__ void __launch_bounds__(NT)
minplus_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ C, int M, int K, int N) {
    __shared__ float As[BK][BM];     // As[k][i] = A[row0 + i, k0 + k]
    __shared__ float Bs[BK][BN];     // Bs[k][j] = B[k0 + k, col0 + j]

    const int bt = blockIdx.z;
    const float* a = A + (size_t)bt * M * K;
    const float* b = B + (size_t)bt * K * N;
    float* c = C + (size_t)bt * M * N;
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;
    const int tid = threadIdx.x;
    const int ty = tid / (BN / TN);
    const int tx = tid % (BN / TN);

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = BIG;

    for (int k0 = 0; k0 < K; k0 += BK) {
        for (int l = tid; l < BM * BK; l += NT) {
            const int i = l / BK, kk = l % BK;
            const int gi = row0 + i, gk = k0 + kk;
            As[kk][i] = (gi < M && gk < K) ? a[(size_t)gi * K + gk] : BIG;
        }
        for (int l = tid; l < BK * BN; l += NT) {
            const int kk = l / BN, j = l % BN;
            const int gk = k0 + kk, gj = col0 + j;
            Bs[kk][j] = (gk < K && gj < N) ? b[(size_t)gk * N + gj] : BIG;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float av[TM], bv[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = fminf(acc[i][j], av[i] + bv[j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int gi = row0 + ty + 16 * i;
        if (gi >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int gj = col0 + tx + 16 * j;
            if (gj < N) c[(size_t)gi * N + gj] = fminf(acc[i][j], BIG);
        }
    }
}

}  // namespace

// a: [Bt, M, K], b: [Bt, K, N], c: [Bt, M, N]; float32, contiguous, on
// the current device.  Launches on `stream` and returns the launch's
// cudaError_t (0 = success); the caller raises on anything else.
extern "C" int minplus_launch(const float* a, const float* b, float* c,
                              int Bt, int M, int K, int N, void* stream) {
    if (Bt <= 0 || M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, Bt);
    minplus_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(a, b, c, M, K, N);
    return (int)cudaGetLastError();
}
