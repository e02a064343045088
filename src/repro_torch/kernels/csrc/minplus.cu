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
// lanes.  At q=19 (722^3) that is ~22.5 us per squaring at 1.98 GHz;
// the bytes (2 MB in, 2 MB out) take ~1.2 us, so the kernel is bound by
// operations, not memory.  Each SM sub-partition issues one warp
// instruction per clock, so the two instructions of an element take two
// issue slots whatever the pipe that runs FMNMX; chip_smoke.py measures
// the FADD, FMNMX and interleaved rates with `minplus_probe_kernel`.
//
// Design.
// * Work for every SM (stream-K).  The iterations (batch, 128x128 output
//   tile, K-chunk of 8) are laid end to end, tile-major, and a persistent
//   grid of SMs x resident blocks takes equal contiguous shares: block j
//   takes [j T / G, (j + 1) T / G) of the T iterations, which may cross
//   tile boundaries.  A block keeps one tile's partial minimum over its
//   chunks in registers and folds it into C with atomics when the tile
//   (or its share) ends.  min is exact in any order, so the K split
//   changes no bit.  `repro_torch.kernels.minplus.work_plan` mirrors the
//   partition (a CPU test holds it).
// * Exact atomic min of floats.  C is first filled with the bytes 0x7f
//   (3.39e38, above any partial, which is <= 3e38).  A partial with the
//   sign bit clear is folded by a signed atomicMin of its bits (the bits
//   of non-negative floats order as the floats, and every negative float
//   is a negative int, so it is kept); one with the sign bit set by an
//   unsigned atomicMax of its bits (negative floats order in reverse as
//   unsigned, and above every non-negative one).  Exact for every float
//   but NaN, so for any inputs whose sums are not inf - inf.
//   The flush goes through shared memory in four passes of 32 tile rows,
//   so a warp's atomics cover 32 consecutive words (4 whole sectors).
//   Measured at 722^3 on an H100, the whole flush costs ~3 us of the
//   kernel's ~63: the inner loop, not the K split, sets the time.
// * 8x8 register micro-tile.  256 threads, thread (ty, tx) owns rows
//   4ty..4ty+3 and 64+4ty.. of the tile and the same columns by tx: per
//   k, 4 LDS.128 (A from a transposed tile, B as stored) feed 64 FADD +
//   64 FMNMX.  A warp's A reads are two broadcasts and its B reads 16
//   consecutive float4s: no bank conflicts.  A warp copies one k-run of
//   32 consecutive A rows, so its stores into the transposed tile land
//   in 32 distinct banks.
// * Overlapped staging.  A q=19 row is 2,888 B, not a multiple of 16, so
//   neither TMA (16-byte strides) nor 16-byte cp.async applies: a
//   3-stage ring in shared memory is filled by 4-byte cp.async, two
//   chunks ahead of the one computing, with 3e38 stored past the ragged
//   edges; one __syncthreads per chunk, and no registers held by the
//   copies.
// * __launch_bounds__(256, 2): at most 128 registers, two blocks (16
//   warps, 2 x 24 KiB of ring) per SM.  Measured on an H100: a 4x8
//   tile at 3-4 blocks per SM, K-chunks of 16, a 2- or 4-deep ring and
//   one block per SM were no faster.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int TM = 8;            // tile rows a thread owns (a multiple of 4)
constexpr int TN = 8;            // tile columns a thread owns
constexpr int BM = 16 * TM;
constexpr int BN = 16 * TN;
constexpr int BK = 8;
constexpr int NT = 256;          // (BM / TM) * (BN / TN) threads
constexpr int A_PER = BM * BK / NT;        // A elements a thread copies
constexpr int B_PER = BK * BN / NT;        // B elements a thread copies
constexpr int STAGES = 3;        // ring depth
constexpr int STAGE = BK * BM + BK * BN;   // floats of one ring stage
constexpr int FLUSH_ROWS = 32;   // tile rows per pass of the flush
constexpr int MIN_BLOCKS = 2;
constexpr float BIG = 3.0e38f;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
    if (__float_as_int(v) >= 0)
        atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
    else
        atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__global__ void __launch_bounds__(NT, MIN_BLOCKS)
minplus_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ C, int M, int K, int N, int tiles_n,
               int tiles, int kchunks, int total, int n_blocks) {
    // the ring: stage s holds As[k][i] then Bs[k][j]; the
    // flush reuses its first FLUSH_ROWS x BN floats
    __shared__ __align__(16) float smem[STAGES * STAGE];

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    // copy roles: a warp copies one k-run of 32 consecutive A rows (its
    // stores to the transposed tile hit 32 banks) and whole B row pieces
    const int a_row = tid % BM, a_k = (tid / BM) * A_PER;
    const int b_k = tid / (BN / B_PER), b_col = (tid % (BN / B_PER)) * B_PER;

    // iteration indices are int32 (the launcher refuses T >= 2^31); the
    // products of the shares are taken in 64 bits
    int it = (int)((long long)blockIdx.x * total / n_blocks);
    const int end = (int)((long long)(blockIdx.x + 1) * total / n_blocks);

    while (it < end) {
        const int tg = it / kchunks;
        const int kc0 = it - tg * kchunks;
        const int kc1 = min(kchunks, kc0 + (end - it));
        const int bt = tg / tiles;
        const int tile = tg - bt * tiles;
        const int row0 = (tile / tiles_n) * BM, col0 = (tile % tiles_n) * BN;
        const int ai = row0 + a_row;
        const float* arow = A + ((size_t)bt * M + (ai < M ? ai : 0)) * K;
        const float* bcol = B + (size_t)bt * K * N + col0 + b_col;
        float* c = C + (size_t)bt * M * N;

        // copy chunk kc into ring stage `st`: A_PER + B_PER asynchronous
        // 4-byte copies a thread; past the ragged edges 3e38 is stored
        auto issue = [&](int kc, int st) {
            float* as = smem + st * STAGE;
            float* bs = as + BK * BM;
            const int k0 = kc * BK;
#pragma unroll
            for (int q = 0; q < A_PER; ++q) {
                const int gk = k0 + a_k + q;
                float* d = as + (a_k + q) * BM + a_row;
                if (ai < M && gk < K) cp_async4(d, arow + gk);
                else *d = BIG;
            }
            const int gk = k0 + b_k;
#pragma unroll
            for (int q = 0; q < B_PER; ++q) {
                float* d = bs + b_k * BN + b_col + q;
                if (gk < K && col0 + b_col + q < N)
                    cp_async4(d, bcol + (size_t)gk * N + q);
                else *d = BIG;
            }
        };

        float acc[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = BIG;

        // chunk kc0 + n is commit group n, STAGES - 1 chunks ahead
#pragma unroll
        for (int n = 0; n < STAGES - 1; ++n) {
            if (kc0 + n < kc1) issue(kc0 + n, n);
            cp_async_commit();
        }
        int st = 0;
        for (int kc = kc0; kc < kc1; ++kc) {
            cp_async_wait<STAGES - 2>();  // chunk kc has landed (this thread)
            __syncthreads();              // ... every thread's; stage st - 1
                                          // is read by nobody any more
            if (kc + STAGES - 1 < kc1)
                issue(kc + STAGES - 1, st == 0 ? STAGES - 1 : st - 1);
            cp_async_commit();
            const float* as = smem + st * STAGE;
            const float* bs = as + BK * BM;
#pragma unroll
            for (int kk = 0; kk < BK; ++kk) {
                // rows 64h + 4ty.. and columns 64h + 4tx.., h = 0, 1
                float av[TM], bv[TN];
#pragma unroll
                for (int h = 0; h < TM / 4; ++h) {
                    const float4 v = *reinterpret_cast<const float4*>(
                        as + kk * BM + 64 * h + 4 * ty);
                    av[4 * h] = v.x; av[4 * h + 1] = v.y;
                    av[4 * h + 2] = v.z; av[4 * h + 3] = v.w;
                }
#pragma unroll
                for (int h = 0; h < TN / 4; ++h) {
                    const float4 v = *reinterpret_cast<const float4*>(
                        bs + kk * BN + 64 * h + 4 * tx);
                    bv[4 * h] = v.x; bv[4 * h + 1] = v.y;
                    bv[4 * h + 2] = v.z; bv[4 * h + 3] = v.w;
                }
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j)
                        acc[i][j] = fminf(acc[i][j], av[i] + bv[j]);
            }
            st = st == STAGES - 1 ? 0 : st + 1;
        }

        // fold the tile's partial into C: BM / 32 passes of 32 tile rows
        // through shared memory, so that a warp's atomics cover 32
        // consecutive words of one row (4 whole sectors)
        float* stg = smem;
#pragma unroll
        for (int p = 0; p < BM / FLUSH_ROWS; ++p) {
            __syncthreads();              // ring / previous pass released
            if ((ty >> 3) == (p & 1)) {
#pragma unroll
                for (int ii = 0; ii < 4; ++ii) {
                    const int r = 4 * (p >> 1) + ii;   // unrolled: constant
                    float* row = stg + (4 * (ty & 7) + ii) * BN;
                    *reinterpret_cast<float4*>(row + 4 * tx) = make_float4(
                        acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
                    *reinterpret_cast<float4*>(row + 64 + 4 * tx) =
                        make_float4(acc[r][4], acc[r][5], acc[r][6],
                                    acc[r][7]);
                }
            }
            __syncthreads();
#pragma unroll 4
            for (int e = tid; e < FLUSH_ROWS * BN; e += NT) {
                const int gi = row0 + FLUSH_ROWS * p + e / BN;
                const int gj = col0 + e % BN;
                if (gi < M && gj < N)
                    atomic_min_float(c + (size_t)gi * N + gj, stg[e]);
            }
        }
        __syncthreads();                  // before the next tile's copies
        it += kc1 - kc0;
    }
}

// Issue-rate probe: every thread runs `iters` rounds of 8 independent
// chains of one instruction kind -- mode 0: FADD, 1: FMNMX, 2: the
// kernel's FADD + FMNMX pair -- and writes its result so nothing is
// dead.  Instructions per SM per clock = 8 * iters * threads (x2 in mode
// 2) / (time * clock * SMs).
__global__ void __launch_bounds__(NT)
minplus_probe_kernel(float* __restrict__ out, int mode, int iters,
                     float seed) {
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = seed * (threadIdx.x + i);
    const float y = seed * blockIdx.x;
    if (mode == 0) {
        for (int r = 0; r < iters; ++r)
#pragma unroll
            for (int i = 0; i < 8; ++i) x[i] = x[i] + x[(i + 1) & 7];
    } else if (mode == 1) {
        for (int r = 0; r < iters; ++r)
#pragma unroll
            for (int i = 0; i < 8; ++i) x[i] = fminf(x[i], x[(i + 1) & 7]);
    } else {
        for (int r = 0; r < iters; ++r)
#pragma unroll
            for (int i = 0; i < 8; ++i)
                x[i] = fminf(x[i], x[(i + 1) & 7] + y);
    }
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s += x[i];
    out[blockIdx.x * NT + threadIdx.x] = s;
}

}  // namespace

// Persistent grid of the kernel on the current device: the SM count times
// the blocks that fit on one SM.  Writes it to *n_blocks; returns a
// cudaError_t (0 = success).
extern "C" int minplus_grid(int* n_blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, minplus_kernel,
                                                      NT, 0);
    if (e != cudaSuccess) return (int)e;
    *n_blocks = sms * (per_sm > 0 ? per_sm : 1);
    return 0;
}

// a: [Bt, M, K], b: [Bt, K, N], c: [Bt, M, N]; float32, contiguous, on
// the current device.  Fills c with 0x7f bytes, then launches
// min(n_blocks, T) blocks, T = Bt * ceil(M/128) * ceil(N/128) *
// ceil(K/8) < 2^31, on `stream`; returns the first error's cudaError_t
// (0 = success); the caller raises on anything else.
extern "C" int minplus_launch(const float* a, const float* b, float* c,
                              int Bt, int M, int K, int N, int n_blocks,
                              void* stream) {
    if (Bt <= 0 || M <= 0 || N <= 0 || K <= 0 || n_blocks <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int tiles_n = (N + BN - 1) / BN;
    const int tiles = ((M + BM - 1) / BM) * tiles_n;
    const int kchunks = (K + BK - 1) / BK;
    const long long total = (long long)Bt * tiles * kchunks;
    if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const int nb = (int)(total < n_blocks ? total : n_blocks);
    cudaError_t e = cudaMemsetAsync(c, 0x7f, sizeof(float) * Bt * M * N, st);
    if (e != cudaSuccess) return (int)e;
    minplus_kernel<<<nb, NT, 0, st>>>(a, b, c, M, K, N, tiles_n, tiles,
                                      kchunks, (int)total, nb);
    return (int)cudaGetLastError();
}

// The issue-rate probe on `blocks` blocks of 256 threads; out holds
// blocks * 256 floats.
extern "C" int minplus_probe_launch(float* out, int mode, int iters,
                                    int blocks, void* stream) {
    if (mode < 0 || mode > 2 || iters < 1 || blocks < 1)
        return (int)cudaErrorInvalidValue;
    minplus_probe_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
        out, mode, iters, 1.0e-3f);
    return (int)cudaGetLastError();
}
