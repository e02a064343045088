// GQA decode attention (flash-decoding) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_attention_pallas` (body
// `_decode_kernel`) of src/repro/kernels/attn_decode.py:81.  It runs in
// every attention layer of every decode step of the serving path
// (models.layers.attention_block, decode branch).
//
// Contract (B batch rows, Hkv kv heads, G query heads per kv head,
// S cache positions, d head dim; all tensors contiguous):
//   in   q [B, Hkv, G, d]        float32 or bfloat16
//        k, v [B, Hkv, S, d]     float32 or bfloat16 (one type for both)
//        length [B] int32        valid positions, 1 <= length[b] <= S
//   out  o [B, Hkv, G, d]        q's type
// For each (b, kv head) the G query rows attend over positions
// [0, length[b]): s = (q . k) * scale, then cap * tanh(s / cap) when a cap
// is given, a float32 softmax, o = softmax . v.  d <= 256 and G <= 16.
//
// Bound on this card.  The call is bound by its bytes: it must read the
// K and V of the valid positions, sum_b length[b] * Hkv * 2 * d * elem,
// and does ~4 G d flops per position on them (8 flops per float32 byte
// at G = 2, far below the card's ~20 float32 flops per byte).  At the
// full gemma2-2b global-layer shape (B = 4, Hkv = 4, S = 8192, d = 256,
// float32, every row full) that is 268 MB, 80 us at 3.35 TB/s.
//
// Design.  The TPU kernel walks S in order on one core and carries its
// running max, sum and accumulator across grid steps.  Hopper has no
// ordered grid, and one block per (b, head) would give 16 blocks for 132
// SMs at the serving shape.  So S is split (flash-decoding): the grid is
// (B * Hkv, n_split), with n_split chosen by the wrapper so that about
// two blocks per SM are resident (16 splits of 512 positions at the
// global-layer shape: 256 blocks).  Each block streams its chunk of S in
// tiles of 32 positions: K and V go through shared memory with 16-byte
// coalesced loads (converted to float32 there), each warp scores whole
// (position, row) pairs (warp-reduced dot products), one warp per row
// updates the running max and sum, and every thread folds the tile's
// probabilities into its share of the G x d accumulator (registers).
// Positions at or beyond length[b] are never read: a block clips its
// chunk to the valid length, and a block whose chunk holds no valid
// position writes m = -3e38, l = 0 and a zero accumulator, which the merge
// weighs by exp(-3e38 - M) = 0.  A second kernel merges the splits
// (rescaling each by exp(m_s - M)) and writes o = acc / l in q's type.
// Arithmetic is float32 throughout, with the accurate expf and tanhf.
// Tensor cores, TMA and a deeper load pipeline are left for later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                 // threads per block (8 warps)
constexpr int NWARP = NT / 32;
constexpr int TS = 32;                  // positions per tile (one per lane)
constexpr int MAX_D = 256;
constexpr int MAX_G = 16;
constexpr int MAX_PER_THREAD = MAX_G * MAX_D / NT;   // accumulators a thread
constexpr int UNROLL = 8;               // 16-byte loads in flight per thread
constexpr float NEG_BIG = -3.0e38f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void from_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f(float x, bf16* dst) {
    *dst = __float2bfloat16_rn(x);
}

// 16 loaded bytes -> float32 values in shared memory (dst 16-byte aligned)
__device__ __forceinline__ void unpack16(float* dst, const uint4& r,
                                         const float*) {
    *reinterpret_cast<float4*>(dst) = make_float4(
        __uint_as_float(r.x), __uint_as_float(r.y), __uint_as_float(r.z),
        __uint_as_float(r.w));
}
__device__ __forceinline__ float bf_lo(unsigned int w) {
    return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(unsigned int w) {
    return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack16(float* dst, const uint4& r,
                                         const bf16*) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    d4[0] = make_float4(bf_lo(r.x), bf_hi(r.x), bf_lo(r.y), bf_hi(r.y));
    d4[1] = make_float4(bf_lo(r.z), bf_hi(r.z), bf_lo(r.w), bf_hi(r.w));
}

// Copy n consecutive elements of k and of v (one tile: nt rows of d) into
// float32 shared memory.  vec: 16-byte loads (n a multiple of 16 / elem,
// sources 16-byte aligned); else one element at a time.
template <typename KT>
__device__ __forceinline__ void load_kv(float* k_s, float* v_s,
                                        const KT* __restrict__ k,
                                        const KT* __restrict__ v, int n,
                                        bool vec) {
    if (vec) {
        constexpr int PER = 16 / sizeof(KT);
        const int nv = n / PER;
        const uint4* k4 = reinterpret_cast<const uint4*>(k);
        const uint4* v4 = reinterpret_cast<const uint4*>(v);
        for (int base = threadIdx.x; base < nv; base += NT * UNROLL) {
            uint4 rk[UNROLL], rv[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int i = base + u * NT;
                if (i < nv) {
                    rk[u] = __ldg(k4 + i);
                    rv[u] = __ldg(v4 + i);
                }
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int i = base + u * NT;
                if (i < nv) {
                    unpack16(k_s + i * PER, rk[u], k);
                    unpack16(v_s + i * PER, rv[u], v);
                }
            }
        }
    } else {
        for (int i = threadIdx.x; i < n; i += NT) {
            k_s[i] = to_f(k[i]);
            v_s[i] = to_f(v[i]);
        }
    }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

// Shared memory of one block, in floats.
__host__ __device__ __forceinline__ int smem_floats(int G, int d) {
    return 2 * TS * d + G * d + G * TS + 3 * G;
}

// One block: kv head bh = b * Hkv + h, positions [split * chunk,
// (split + 1) * chunk) clipped to length[b]; writes its partial
// (m, l) to ws_ml [BH, n_split, 2, G] and acc to ws_acc [BH, n_split, G, d].
template <typename QT, typename KT>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const int* __restrict__ length,
                    float* __restrict__ ws_ml, float* __restrict__ ws_acc,
                    int Hkv, int G, int d, int S, int chunk, float scale,
                    float cap, bool has_cap, bool vec) {
    static_assert(TS == 32, "the softmax step gives one position per lane");
    extern __shared__ __align__(16) float smem[];
    float* k_s = smem;                  // [TS, d]
    float* v_s = k_s + TS * d;          // [TS, d]
    float* q_s = v_s + TS * d;          // [G, d]
    float* p_s = q_s + G * d;           // [G, TS] scores, then probabilities
    float* m_s = p_s + G * TS;          // [G] running max
    float* l_s = m_s + G;               // [G] running sum
    float* c_s = l_s + G;               // [G] rescale of the current tile

    const int bh = blockIdx.x;
    const int split = blockIdx.y;
    const int n_split = gridDim.y;
    const int b = bh / Hkv;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int Gd = G * d;
    const int s0 = split * chunk;
    const int s_end = min(min(s0 + chunk, S), length[b]);
    const bool d4 = (d & 3) == 0;       // rows of k_s and q_s 16-byte aligned

    const QT* qb = q + (size_t)bh * Gd;
    for (int i = tid; i < Gd; i += NT) q_s[i] = to_f(qb[i]);
    for (int g = tid; g < G; g += NT) {
        m_s[g] = NEG_BIG;
        l_s[g] = 0.f;
    }
    float acc[MAX_PER_THREAD];
#pragma unroll
    for (int r = 0; r < MAX_PER_THREAD; ++r) acc[r] = 0.f;
    __syncthreads();

    const KT* kb = k + (size_t)bh * S * d;
    const KT* vb = v + (size_t)bh * S * d;
    for (int t0 = s0; t0 < s_end; t0 += TS) {
        const int nt = min(TS, s_end - t0);
        load_kv(k_s, v_s, kb + (size_t)t0 * d, vb + (size_t)t0 * d, nt * d,
                vec);
        __syncthreads();

        // scores: warp w takes the (position, row) pairs w, w + 8, ...;
        // its lanes split the head dim (16-byte reads when d % 4 == 0)
        for (int pr = warp; pr < nt * G; pr += NWARP) {
            const int t = pr / G, g = pr - t * G;
            const float* kr = k_s + t * d;
            const float* qr = q_s + g * d;
            float part = 0.f;
            if (d4) {
                for (int c = 4 * lane; c < d; c += 128) {
                    const float4 kc = *reinterpret_cast<const float4*>(kr + c);
                    const float4 qc = *reinterpret_cast<const float4*>(qr + c);
                    part = fmaf(qc.x, kc.x, part);
                    part = fmaf(qc.y, kc.y, part);
                    part = fmaf(qc.z, kc.z, part);
                    part = fmaf(qc.w, kc.w, part);
                }
            } else {
                for (int c = lane; c < d; c += 32)
                    part = fmaf(qr[c], kr[c], part);
            }
            float s = warp_sum(part) * scale;
            if (has_cap) s = cap * tanhf(s / cap);
            if (lane == 0) p_s[g * TS + t] = s;
        }
        __syncthreads();

        // online softmax: warp w updates rows w, w + 8 (lane = position)
        for (int g = warp; g < G; g += NWARP) {
            const float s = lane < nt ? p_s[g * TS + lane] : NEG_BIG;
            const float m_old = m_s[g];
            const float m_new = fmaxf(m_old, warp_max(s));
            const float p = lane < nt ? expf(s - m_new) : 0.f;
            p_s[g * TS + lane] = p;
            const float psum = warp_sum(p);
            if (lane == 0) {
                const float corr = expf(m_old - m_new);
                c_s[g] = corr;
                m_s[g] = m_new;
                l_s[g] = l_s[g] * corr + psum;
            }
        }
        __syncthreads();

        // accumulate: thread owns elements tid, tid + NT, ... of [G, d]
#pragma unroll
        for (int r = 0; r < MAX_PER_THREAD; ++r) {
            const int i = tid + r * NT;
            if (i < Gd) {
                const int g = i / d, c = i - g * d;
                const float* pg = p_s + g * TS;
                float a = acc[r] * c_s[g];
                for (int t = 0; t < nt; ++t) a = fmaf(pg[t], v_s[t * d + c], a);
                acc[r] = a;
            }
        }
        __syncthreads();
    }

    const size_t part_idx = (size_t)bh * n_split + split;
    float* ml = ws_ml + part_idx * 2 * G;
    for (int g = tid; g < G; g += NT) {
        ml[g] = m_s[g];
        ml[G + g] = l_s[g];
    }
    float* wa = ws_acc + part_idx * Gd;
#pragma unroll
    for (int r = 0; r < MAX_PER_THREAD; ++r) {
        const int i = tid + r * NT;
        if (i < Gd) wa[i] = acc[r];
    }
}

// One block per kv head: o = sum_s e_s acc_s / sum_s e_s l_s with
// e_s = exp(m_s - max_s m_s); an empty split has e_s = 0.
template <typename QT>
__global__ void __launch_bounds__(NT)
decode_merge_kernel(const float* __restrict__ ws_ml,
                    const float* __restrict__ ws_acc, QT* __restrict__ out,
                    int G, int d, int n_split) {
    const int bh = blockIdx.x;
    const int Gd = G * d;
    const float* ml = ws_ml + (size_t)bh * n_split * 2 * G;
    const float* wa = ws_acc + (size_t)bh * n_split * Gd;
    for (int i = threadIdx.x; i < Gd; i += NT) {
        const int g = i / d;
        float M = NEG_BIG;
        for (int s = 0; s < n_split; ++s) M = fmaxf(M, ml[s * 2 * G + g]);
        float num = 0.f, den = 0.f;
        for (int s = 0; s < n_split; ++s) {
            const float e = expf(ml[s * 2 * G + g] - M);
            num = fmaf(e, wa[(size_t)s * Gd + i], num);
            den = fmaf(e, ml[s * 2 * G + G + g], den);
        }
        from_f(num / den, out + (size_t)bh * Gd + i);
    }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const int* length,
           void* out, float* ws_ml, float* ws_acc, int BH, int Hkv, int G,
           int d, int S, int n_split, int chunk, float scale, float cap,
           int has_cap, cudaStream_t stream) {
    const size_t smem = sizeof(float) * (size_t)smem_floats(G, d);
    // the attribute belongs to the current device: set it on every launch
    // (it is cheap), so a launch on any card gets its shared memory
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<QT, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const bool vec = (d * (int)sizeof(KT)) % 16 == 0
                     && (reinterpret_cast<uintptr_t>(k) % 16) == 0
                     && (reinterpret_cast<uintptr_t>(v) % 16) == 0;
    decode_split_kernel<QT, KT><<<dim3(BH, n_split), NT, smem, stream>>>(
        static_cast<const QT*>(q), static_cast<const KT*>(k),
        static_cast<const KT*>(v), length, ws_ml, ws_acc, Hkv, G, d, S,
        chunk, scale, cap, has_cap != 0, vec);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    decode_merge_kernel<QT><<<BH, NT, 0, stream>>>(
        ws_ml, ws_acc, static_cast<QT*>(out), G, d, n_split);
    return (int)cudaGetLastError();
}

}  // namespace

// Launches the split kernel on a (B * Hkv, n_split) grid and the merge
// kernel on B * Hkv blocks, both on `stream`; returns the first launch
// error's cudaError_t (0 = success).  q_bf16 / kv_bf16: 1 for bfloat16,
// 0 for float32.  Workspaces: ws_ml [B * Hkv * n_split * 2 * G] and
// ws_acc [B * Hkv * n_split * G * d] float32.  The caller checks dtypes,
// shapes, contiguity, the device, d <= 256, G <= 16 and
// n_split * chunk >= S.
extern "C" int attn_decode_launch(
        const void* q, const void* k, const void* v, const int* length,
        void* out, float* ws_ml, float* ws_acc, int B, int Hkv, int G, int d,
        int S, int n_split, int chunk, float scale, float cap, int has_cap,
        int q_bf16, int kv_bf16, void* stream) {
    if (B < 1 || Hkv < 1 || G < 1 || G > MAX_G || d < 1 || d > MAX_D
        || S < 1 || n_split < 1 || chunk < 1
        || (long long)n_split * chunk < S)
        return (int)cudaErrorInvalidValue;
    const int BH = B * Hkv;
    cudaStream_t st = (cudaStream_t)stream;
    if (q_bf16) {
        return kv_bf16
            ? launch<bf16, bf16>(q, k, v, length, out, ws_ml, ws_acc, BH, Hkv,
                                 G, d, S, n_split, chunk, scale, cap, has_cap,
                                 st)
            : launch<bf16, float>(q, k, v, length, out, ws_ml, ws_acc, BH,
                                  Hkv, G, d, S, n_split, chunk, scale, cap,
                                  has_cap, st);
    }
    return kv_bf16
        ? launch<float, bf16>(q, k, v, length, out, ws_ml, ws_acc, BH, Hkv, G,
                              d, S, n_split, chunk, scale, cap, has_cap, st)
        : launch<float, float>(q, k, v, length, out, ws_ml, ws_acc, BH, Hkv,
                               G, d, S, n_split, chunk, scale, cap, has_cap,
                               st);
}
