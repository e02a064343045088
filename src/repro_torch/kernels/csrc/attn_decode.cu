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
// float32, every row full) that is 268 MB, 80 us at 3.35 TB/s; the
// serving step's rows (lengths ~4500/2049/1024/300) read a quarter of it.
// What keeps a kernel from that bound is (1) SMs left idle by a split
// that follows S instead of the valid rows, (2) loads that wait for
// compute, (3) per-tile compute with too few warps to hide its latency
// (bfloat16 halves the bytes but not the work per position), and (4)
// fixed costs per call: start-up, merges, the second launch.
//
// Design.  (1) The work is the valid tiles of TS = 32 positions of every
// (b, kv head) segment, T = sum_b Hkv * ceil(length[b] / TS), counted on
// the device from `length` (no host sync, no host lengths; a warp loads
// 32 rows at once).  A grid of persistent blocks (the SM count times the
// blocks that fit on one SM) splits them evenly: block j takes the tiles
// [j T / nb, (j+1) T / nb) of the segments laid end to end, so a short
// row costs its own tiles and no more, and every block gets its share to
// within one tile.  A share may cross segments; it writes one float32
// partial (m, l, acc) per segment piece, in slot (segment + j), which is
// unique along the staircase of (segment, block) pieces and
// < B Hkv + nb - 1 for any lengths (kernels/attn_decode.py::work_plan).
// (2) K/V tiles stream through a ring of 3-4 shared-memory stages kept in
// the stored type, filled by TMA bulk copies (cp.async.bulk, one
// contiguous run of nt * d elements of K and one of V per tile) that
// complete on an mbarrier; thread 0 keeps the ring up to 3 tiles ahead of
// the tile being computed, refilling a stage once every warp has arrived
// on its "empty" mbarrier.  (3) Each warp owns a subset of the tile's
// positions and a group of up to GR query rows, with q, the running max
// and sum and the accumulator in registers (a lane holds 8 columns per
// row: 16 accumulators at G = 2, d = 256), and there is no block barrier
// per tile: 16 warps take 2 positions each at G <= 2 (8 warps of 4 at
// larger G).  The butterfly gives every lane every score, so each lane
// runs the online softmax itself; the warps' states are merged through
// shared memory once per segment piece.  (4) q is loaded while a piece's
// first tile is awaited, and the merge kernel, which finds a segment's
// pieces from the same arithmetic and rescales each by exp(m - M), is
// launched as a programmatic dependent: its blocks start while the split
// kernel drains.  Where d * elem is not a multiple of 16 bytes or K/V are
// not 16-byte aligned, the block copies each tile itself into zero-padded
// rows instead (two barriers per tile).  Arithmetic is float32 with the
// accurate expf and tanhf (the cap's division is a multiply by 1 / cap);
// positions at or past length[b] are never read.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Warps of a block and positions a warp takes at once, by row group GR:
// sixteen warps of two positions each per tile when a warp holds all of
// G <= 2 rows (gemma2-2b: more warps hide the latency of each warp's
// chain), eight warps of four otherwise (registers: 4 rows x 8 columns of
// q and of the accumulator per lane).
template <int GR> struct Shape {
    static constexpr int NWARP = GR <= 2 ? 16 : 8;
    static constexpr int NT = 32 * NWARP;
    static constexpr int PB = GR <= 2 ? 2 : 4;
};
constexpr int MAX_NWARP = 16;
constexpr int TS = 32;                  // positions per tile
constexpr int MAX_D = 256;
constexpr int MAX_G = 16;
constexpr int COLS = 8;                 // columns of a row held by a lane
constexpr int SMEM_LIMIT = 227 * 1024;  // dynamic shared memory per block
constexpr int MT = 128;                 // threads per merge block
constexpr int MAX_BLOCKS = 2048;        // split blocks the merge can weigh
constexpr float NEG_BIG = -3.0e38f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f(float x, bf16* dst) {
    *dst = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float bf_lo(unsigned int w) {
    return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(unsigned int w) {
    return __uint_as_float(w & 0xffff0000u);
}

// A 16-byte chunk of a stored row: VEC elements; a lane owns NCH chunks
// (lane, lane + 32, ...), COLS = VEC * NCH columns.
template <typename KT> struct Chunk;
template <> struct Chunk<float> {
    static constexpr int VEC = 4, NCH = 2;
    __device__ static void unpack(const uint4& r, float* f) {
        f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
        f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
    }
};
template <> struct Chunk<bf16> {
    static constexpr int VEC = 8, NCH = 1;
    __device__ static void unpack(const uint4& r, float* f) {
        f[0] = bf_lo(r.x); f[1] = bf_hi(r.x); f[2] = bf_lo(r.y);
        f[3] = bf_hi(r.y); f[4] = bf_lo(r.z); f[5] = bf_hi(r.z);
        f[6] = bf_lo(r.w); f[7] = bf_hi(r.w);
    }
};

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

// ---- mbarrier and TMA bulk copy (PTX)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(n) : "memory");
}
// wait for the completion of the phase of parity `par`
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

// ---- the work plan (kernels/attn_decode.py::work_plan mirrors it)
__device__ __forceinline__ int row_len(const int* length, int b, int S) {
    return min(max(length[b], 0), S);
}
__device__ __forceinline__ int row_tiles(int len) {
    return (len + TS - 1) / TS;
}
// first tile of block j's share
__device__ __forceinline__ long long share_start(long long j, long long T,
                                                 long long nb) {
    return j * T / nb;
}
// the block whose share holds tile t (0 <= t < T)
__device__ __forceinline__ int owner(long long t, long long T, long long nb) {
    return (int)(((t + 1) * nb - 1) / T);
}

// Tiles of rows [0, lim), sum_r Hkv * ceil(length[r] / TS): the lanes load
// 32 rows at a time (one round trip for B <= 32); every lane gets it.
__device__ long long warp_rows_tiles(const int* length, int lim, int S,
                                     int Hkv, int lane) {
    long long tot = 0;
    for (int r0 = 0; r0 < lim; r0 += 32) {
        const int r = r0 + lane;
        int rt = r < lim ? Hkv * row_tiles(row_len(length, r, S)) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            rt += __shfl_xor_sync(0xffffffffu, rt, o);
        tot += rt;
    }
    return tot;
}

// Tiles of all rows and of the rows below `lim` (warp-wide, as above).
__device__ void warp_tiles_below(const int* length, int B, int lim, int S,
                                 int Hkv, int lane, long long* all,
                                 long long* below) {
    long long tot = 0, low = 0;
    for (int r0 = 0; r0 < B; r0 += 32) {
        const int r = r0 + lane;
        int rt = r < B ? Hkv * row_tiles(row_len(length, r, S)) : 0;
        int rl = r < lim ? rt : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            rt += __shfl_xor_sync(0xffffffffu, rt, o);
            rl += __shfl_xor_sync(0xffffffffu, rl, o);
        }
        tot += rt;
        low += rl;
    }
    *all = tot;
    *below = low;
}

// The row b whose tiles hold tile `tile` (< T) of the sequence, and the
// tile's index among row b's Hkv * tiles (warp-wide, as above).
__device__ void warp_seek(const int* length, int B, int S, int Hkv,
                          long long tile, int lane, int* b_out,
                          long long* rem_out) {
    long long base = 0;
    for (int r0 = 0; r0 < B; r0 += 32) {
        const int r = r0 + lane;
        const int rt = r < B ? Hkv * row_tiles(row_len(length, r, S)) : 0;
        int incl = rt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int x = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += x;
        }
        const unsigned hit = __ballot_sync(0xffffffffu, base + incl > tile);
        if (hit) {
            const int f = __ffs(hit) - 1;
            const int before = __shfl_sync(0xffffffffu, incl - rt, f);
            *b_out = r0 + f;
            *rem_out = tile - (base + before);
            return;
        }
        base += __shfl_sync(0xffffffffu, incl, 31);
    }
}

// Position in the tile sequence: row b, kv head h, tile t of the segment.
struct Cursor {
    int b, h, t, tiles, len;
    // tile `rem` of row b's Hkv * tiles
    __device__ void init(const int* length, int S, int b_, long long rem) {
        b = b_;
        len = row_len(length, b, S);
        tiles = row_tiles(len);
        h = (int)(rem / tiles);
        t = (int)(rem - (long long)h * tiles);
    }
    __device__ void next(const int* length, int S, int Hkv, int B) {
        if (++t < tiles) return;
        t = 0;
        if (++h < Hkv) return;
        h = 0;
        do {                            // rows of length 0 hold no tile
            if (++b >= B) return;
            len = row_len(length, b, S);
            tiles = row_tiles(len);
        } while (tiles == 0);
    }
    __device__ int nt() const { return min(TS, len - t * TS); }
};

// Shared memory of one block (bytes), stages of the ring, padded head dim.
struct Layout {
    int dp, stages, stage_bytes, off_stage, off_wts, off_mbuf, total;
};
__host__ __device__ inline Layout layout(int d, int elem, int vec, int GR,
                                         int NWARP) {
    Layout L;
    L.dp = (d + vec - 1) / vec * vec;
    L.stage_bytes = 2 * TS * L.dp * elem;                    // K then V
    L.off_stage = 128;                                       // mbarriers
    const int wbytes = MAX_G * MAX_NWARP * 4;                // merge weights
    const int mbuf = NWARP * GR * (L.dp + 2) * 4;
    // four stages where they fit, else three (float32, d = 256), else two
    for (L.stages = 4;; --L.stages) {
        L.off_wts = L.off_stage + L.stages * L.stage_bytes;
        L.off_mbuf = L.off_wts + wbytes;
        L.total = L.off_mbuf + mbuf;
        if (L.total <= SMEM_LIMIT || L.stages == 2) break;
    }
    return L;
}

// One persistent block: its share of the tiles; one partial per segment
// piece, (m, l) to ws_ml [P, 2, G] and acc to ws_acc [P, G, d].
template <typename QT, typename KT, int GR>
__global__ void __launch_bounds__(Shape<GR>::NT, 1)
decode_split_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const int* __restrict__ length,
                    float* __restrict__ ws_ml, float* __restrict__ ws_acc,
                    int B, int Hkv, int G, int d, int S, float scale,
                    float cap, bool has_cap, bool bulk) {
    using C = Chunk<KT>;
    static_assert(C::VEC * C::NCH == COLS, "a lane holds COLS columns");
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr int NWARP = Shape<GR>::NWARP, NT = Shape<GR>::NT;
    constexpr int PB = Shape<GR>::PB;
    const Layout L = layout(d, (int)sizeof(KT), C::VEC, GR, NWARP);
    const int dp = L.dp, S_ = L.stages;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + 4;
    float* wts = reinterpret_cast<float*>(smem + L.off_wts);   // [G, NWARP]
    float* mbuf = reinterpret_cast<float*>(smem + L.off_mbuf);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nb = gridDim.x, j = blockIdx.x;
    // the merge kernel may be scheduled now; it waits for this grid's
    // completion before it reads the partials
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

    const long long T = warp_rows_tiles(length, B, S, Hkv, lane);
    const long long t0 = share_start(j, T, nb);
    const int ntiles = (int)(share_start(j + 1, T, nb) - t0);
    if (ntiles == 0) return;

    // warp roles: row group rg (rows rg*GR ...), position set ps
    const int NRG = GR <= 2 ? 1 : (G + GR - 1) / GR;   // G <= GR below 4
    const int NPS = NWARP / NRG;
    const int rg = warp % NRG, ps = warp / NRG;
    const bool active = ps < NPS;
    const int nchunks = dp / C::VEC;
    const float inv_cap = has_cap ? 1.f / cap : 0.f;

    Cursor cc, pc;
    int b0;
    long long rem0;
    warp_seek(length, B, S, Hkv, t0, lane, &b0, &rem0);
    cc.init(length, S, b0, rem0);
    pc = cc;

    auto stage_k = [&](int s) {
        return reinterpret_cast<KT*>(smem + L.off_stage + s * L.stage_bytes);
    };
    auto issue = [&](int s) {          // thread 0: tile at pc into stage s
        const int nt = pc.nt();
        const uint32_t bytes = (uint32_t)(nt * d * (int)sizeof(KT));
        const size_t off = ((size_t)(pc.b * Hkv + pc.h) * S
                            + (size_t)pc.t * TS) * d;
        KT* ks = stage_k(s);
        mbar_expect_tx(&full[s], 2 * bytes);
        bulk_g2s(ks, k + off, bytes, &full[s]);
        bulk_g2s(ks + TS * dp, v + off, bytes, &full[s]);
        pc.next(length, S, Hkv, B);
    };

    if (bulk) {
        if (tid == 0) {
            for (int s = 0; s < S_; ++s) {
                mbar_init(&full[s], 1);
                mbar_init(&empty[s], NWARP);
            }
            asm volatile("fence.mbarrier_init.release.cluster;\n"
                         ::: "memory");
        }
        __syncthreads();
        if (tid == 0)
            for (int s = 0; s < S_ && s < ntiles; ++s) issue(s);
    }

    float qr[GR][COLS], acc[GR][COLS], m[GR], l[GR];

    for (int it = 0; it < ntiles; ++it) {
        const int seg = cc.b * Hkv + cc.h;
        // a new segment piece: fresh state, and q's loads in flight while
        // the tile is awaited
        if (it == 0 || cc.t == 0) {
            const QT* qb = q + (size_t)seg * G * d;
#pragma unroll
            for (int gi = 0; gi < GR; ++gi) {
                const int g = rg * GR + gi;
                m[gi] = NEG_BIG;
                l[gi] = 0.f;
#pragma unroll
                for (int x = 0; x < C::NCH; ++x)
#pragma unroll
                    for (int e = 0; e < C::VEC; ++e) {
                        const int c = (lane + 32 * x) * C::VEC + e;
                        qr[gi][x * C::VEC + e] =
                            (g < G && c < d) ? to_f(qb[g * d + c]) : 0.f;
                        acc[gi][x * C::VEC + e] = 0.f;
                    }
            }
        }

        int s = 0;
        if (bulk) {
            s = it % S_;
            if (tid == 0 && it >= 1 && it - 1 + S_ < ntiles) {
                const int sp = (it - 1) % S_;
                mbar_wait(&empty[sp], (uint32_t)(((it - 1) / S_) & 1));
                issue(sp);
            }
            mbar_wait(&full[s], (uint32_t)((it / S_) & 1));
        } else {
            // copy the tile into zero-padded rows of stage 0
            __syncthreads();
            const int nt = cc.nt();
            const size_t off = ((size_t)(cc.b * Hkv + cc.h) * S
                                + (size_t)cc.t * TS) * d;
            KT* ks = stage_k(0);
            KT* vs = ks + TS * dp;
            for (int i = tid; i < nt * dp; i += NT) {
                const int r = i / dp, c = i - r * dp;
                const bool in = c < d;
                ks[i] = in ? k[off + (size_t)r * d + c] : KT(0.f);
                vs[i] = in ? v[off + (size_t)r * d + c] : KT(0.f);
            }
            __syncthreads();
        }

        if (active) {
            const int nt = cc.nt();
            const int npw = ps < nt ? (nt - ps + NPS - 1) / NPS : 0;
            const KT* ks = stage_k(s);
            const KT* vs = ks + TS * dp;
            // this warp's positions, PB at a time (a short batch repeats
            // its last position and weighs the copies 0): every lane gets
            // every score from the butterfly, so each lane runs the online
            // softmax itself, with no further reduction
            for (int i = 0; i < npw; i += PB) {
                float kk[PB][COLS], vv[PB][COLS];
#pragma unroll
                for (int u = 0; u < PB; ++u) {
                    const int pu = ps + min(i + u, npw - 1) * NPS;
#pragma unroll
                    for (int x = 0; x < C::NCH; ++x) {
                        // lanes past the row read its last chunk and
                        // zero it (no branch around the loads)
                        const int ci = lane + 32 * x;
                        const int cc_ = min(ci, nchunks - 1) * C::VEC;
                        uint4 rk = *reinterpret_cast<const uint4*>(
                            ks + pu * dp + cc_);
                        uint4 rv = *reinterpret_cast<const uint4*>(
                            vs + pu * dp + cc_);
                        if (ci >= nchunks) rk = rv = make_uint4(0, 0, 0, 0);
                        C::unpack(rk, kk[u] + x * C::VEC);
                        C::unpack(rv, vv[u] + x * C::VEC);
                    }
                }
                float sc[PB][GR];
#pragma unroll
                for (int u = 0; u < PB; ++u)
#pragma unroll
                    for (int gi = 0; gi < GR; ++gi) {
                        float a0 = 0.f;
#pragma unroll
                        for (int c = 0; c < COLS; ++c)
                            a0 = fmaf(qr[gi][c], kk[u][c], a0);
                        sc[u][gi] = a0;
                    }
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
#pragma unroll
                    for (int u = 0; u < PB; ++u)
#pragma unroll
                        for (int gi = 0; gi < GR; ++gi)
                            sc[u][gi] += __shfl_xor_sync(0xffffffffu,
                                                         sc[u][gi], o);
#pragma unroll
                for (int gi = 0; gi < GR; ++gi) {
                    float mx = m[gi];
#pragma unroll
                    for (int u = 0; u < PB; ++u) {
                        float x = sc[u][gi] * scale;
                        if (has_cap) x = cap * tanhf(x * inv_cap);
                        sc[u][gi] = i + u < npw ? x : NEG_BIG;
                        mx = fmaxf(mx, sc[u][gi]);
                    }
                    const float corr = expf(m[gi] - mx);
                    float p[PB], psum = 0.f;
#pragma unroll
                    for (int u = 0; u < PB; ++u) {
                        p[u] = i + u < npw ? expf(sc[u][gi] - mx) : 0.f;
                        psum += p[u];
                    }
                    l[gi] = l[gi] * corr + psum;
                    m[gi] = mx;
#pragma unroll
                    for (int c = 0; c < COLS; ++c) {
                        float a0 = acc[gi][c] * corr;
#pragma unroll
                        for (int u = 0; u < PB; ++u)
                            a0 = fmaf(p[u], vv[u][c], a0);
                        acc[gi][c] = a0;
                    }
                }
            }
        }
        if (bulk) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[s]);
        }

        if (cc.t == cc.tiles - 1 || it == ntiles - 1) {
            // end of a segment piece: merge the warps, write the partial
            __syncthreads();           // mbuf is free (last merge read)
            if (active) {
#pragma unroll
                for (int gi = 0; gi < GR; ++gi) {
                    float* mb = mbuf + (warp * GR + gi) * (dp + 2);
#pragma unroll
                    for (int x = 0; x < C::NCH; ++x) {
                        const int ci = lane + 32 * x;
                        if (ci < nchunks)
#pragma unroll
                            for (int e = 0; e < C::VEC; ++e)
                                mb[ci * C::VEC + e] = acc[gi][x * C::VEC + e];
                    }
                    if (lane == 0) {
                        mb[dp] = m[gi];
                        mb[dp + 1] = l[gi];
                    }
                }
            }
            __syncthreads();
            // row g's weights of the position sets, exp(m_p - M), and the
            // partial's m = M and l = sum_p w_p l_p
            const size_t slot = (size_t)seg + j;
            float* ml = ws_ml + slot * 2 * G;
            float* wa = ws_acc + slot * G * d;
            if (tid < G) {
                const int grp = tid / GR, gi = tid - grp * GR;
                float M = NEG_BIG, den = 0.f;
                for (int p = 0; p < NPS; ++p)
                    M = fmaxf(M, mbuf[((grp + NRG * p) * GR + gi) * (dp + 2)
                                      + dp]);
                for (int p = 0; p < NPS; ++p) {
                    const float* mb = mbuf + ((grp + NRG * p) * GR + gi)
                                      * (dp + 2);
                    const float e = expf(mb[dp] - M);
                    wts[tid * NWARP + p] = e;
                    den = fmaf(e, mb[dp + 1], den);
                }
                ml[tid] = M;
                ml[G + tid] = den;
            }
            __syncthreads();
            for (int i = tid; i < G * d; i += NT) {
                const int g = i / d, c = i - g * d;
                const int grp = g / GR, gi = g - grp * GR;
                float num = 0.f;
                const float* mb = mbuf + (grp * GR + gi) * (dp + 2) + c;
                for (int p = 0; p < NPS; ++p)
                    num = fmaf(wts[g * NWARP + p],
                               mb[NRG * p * GR * (dp + 2)], num);
                wa[i] = num;
            }
        }
        cc.next(length, S, Hkv, B);
    }
}

// Block (segment, row g, chunk of MT columns): o[c] = sum_p e_p acc_p[c] /
// sum_p e_p l_p over the segment's pieces p, e_p = exp(m_p - max m).
// When every block has a share (T >= nb) the pieces are blocks
// owner(first tile) .. owner(last tile); otherwise a block holds at most
// one tile and the pieces are the owners of the segment's tiles.  The
// pieces' (m, l) are loaded in parallel and their weights kept in shared
// memory; then each thread sums its column over the pieces.
template <typename QT>
__global__ void __launch_bounds__(MT)
decode_merge_kernel(const float* __restrict__ ws_ml,
                    const float* __restrict__ ws_acc,
                    const int* __restrict__ length, QT* __restrict__ out,
                    int B, int Hkv, int G, int d, int S, int nb) {
    __shared__ float e_s[MAX_BLOCKS];       // piece m, then weights
    __shared__ float l_s[MAX_BLOCKS];       // piece l
    __shared__ int j_s[MAX_BLOCKS];         // piece blocks
    __shared__ float red[2 * MT / 32];
    const int seg = blockIdx.x, g = blockIdx.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int c = blockIdx.z * MT + tid;
    const int b = seg / Hkv, h = seg - b * Hkv;
    long long T, start;
    warp_tiles_below(length, B, b, S, Hkv, lane, &T, &start);
    const int tiles = row_tiles(row_len(length, b, S));
    start += (long long)h * tiles;
    QT* o = out + ((size_t)seg * G + g) * d;
    if (tiles == 0) {                  // outside the contract: no position
        if (c < d) from_f(0.f, o + c);
        return;
    }
    const bool dense = T >= nb;
    const int j0 = owner(start, T, nb);
    const int n = dense ? owner(start + tiles - 1, T, nb) - j0 + 1 : tiles;
    asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the partials
    const float* ml = ws_ml + (size_t)seg * 2 * G + g;
    float mloc = NEG_BIG;
    for (int p = tid; p < n; p += MT) {
        const int jj = dense ? j0 + p : owner(start + p, T, nb);
        j_s[p] = jj;
        e_s[p] = ml[(size_t)jj * 2 * G];
        l_s[p] = ml[(size_t)jj * 2 * G + G];
        mloc = fmaxf(mloc, e_s[p]);
    }
    mloc = warp_max(mloc);
    if (lane == 0) red[warp] = mloc;
    __syncthreads();
    float M = red[0];
#pragma unroll
    for (int w = 1; w < MT / 32; ++w) M = fmaxf(M, red[w]);
    float dl = 0.f;
    for (int p = tid; p < n; p += MT) {
        const float e = expf(e_s[p] - M);
        e_s[p] = e;
        dl = fmaf(e, l_s[p], dl);
    }
    dl = warp_sum(dl);
    if (lane == 0) red[MT / 32 + warp] = dl;
    __syncthreads();
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < MT / 32; ++w) den += red[MT / 32 + w];
    if (c < d) {
        const float* wa = ws_acc + ((size_t)seg * G + g) * d + c;
        const size_t stride = (size_t)G * d;
        float num = 0.f;
#pragma unroll 8
        for (int p = 0; p < n; ++p)
            num = fmaf(e_s[p], wa[(size_t)j_s[p] * stride], num);
        from_f(num / den, o + c);
    }
}

template <typename QT, typename KT, int GR>
int grid_blocks(int d, int* nb) {
    const Layout L = layout(d, (int)sizeof(KT), Chunk<KT>::VEC, GR,
                            Shape<GR>::NWARP);
    if (L.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<QT, KT, GR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_split_kernel<QT, KT, GR>, Shape<GR>::NT, L.total);
    if (e != cudaSuccess) return (int)e;
    *nb = min(sms * (per_sm > 0 ? per_sm : 1), MAX_BLOCKS);
    return 0;
}

template <typename QT, typename KT, int GR>
int launch(const void* q, const void* k, const void* v, const int* length,
           void* out, float* ws_ml, float* ws_acc, int B, int Hkv, int G,
           int d, int S, int nb, float scale, float cap, int has_cap,
           cudaStream_t stream) {
    const Layout L = layout(d, (int)sizeof(KT), Chunk<KT>::VEC, GR,
                            Shape<GR>::NWARP);
    if (L.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    // the attribute belongs to the current device: set it on every launch
    // (it is cheap), so a launch on any card gets its shared memory
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<QT, KT, GR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return (int)e;
    const bool bulk = (d * (int)sizeof(KT)) % 16 == 0
                      && (reinterpret_cast<uintptr_t>(k) % 16) == 0
                      && (reinterpret_cast<uintptr_t>(v) % 16) == 0;
    decode_split_kernel<QT, KT, GR>
        <<<nb, Shape<GR>::NT, L.total, stream>>>(
        static_cast<const QT*>(q), static_cast<const KT*>(k),
        static_cast<const KT*>(v), length, ws_ml, ws_acc, B, Hkv, G, d, S,
        scale, cap, has_cap != 0, bulk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    // the merge is launched as a programmatic dependent: its blocks start
    // (and count the tiles) while the split kernel drains, and wait for
    // its results at griddepcontrol.wait
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * Hkv, G, (d + MT - 1) / MT);
    cfg.blockDim = dim3(MT);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, decode_merge_kernel<QT>,
                           (const float*)ws_ml, (const float*)ws_acc, length,
                           static_cast<QT*>(out), B, Hkv, G, d, S, nb);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// rows a warp takes: 1, 2 or 4 (G <= 2 gives one group of all rows)
inline int group_rows(int G) { return G <= 1 ? 1 : (G <= 2 ? 2 : 4); }

template <typename QT, typename KT>
int grid_t(int G, int d, int* nb) {
    switch (group_rows(G)) {
        case 1: return grid_blocks<QT, KT, 1>(d, nb);
        case 2: return grid_blocks<QT, KT, 2>(d, nb);
        default: return grid_blocks<QT, KT, 4>(d, nb);
    }
}

template <typename QT, typename KT>
int launch_t(const void* q, const void* k, const void* v, const int* length,
             void* out, float* ws_ml, float* ws_acc, int B, int Hkv, int G,
             int d, int S, int nb, float scale, float cap, int has_cap,
             cudaStream_t st) {
    switch (group_rows(G)) {
        case 1: return launch<QT, KT, 1>(q, k, v, length, out, ws_ml, ws_acc,
                                         B, Hkv, G, d, S, nb, scale, cap,
                                         has_cap, st);
        case 2: return launch<QT, KT, 2>(q, k, v, length, out, ws_ml, ws_acc,
                                         B, Hkv, G, d, S, nb, scale, cap,
                                         has_cap, st);
        default: return launch<QT, KT, 4>(q, k, v, length, out, ws_ml, ws_acc,
                                          B, Hkv, G, d, S, nb, scale, cap,
                                          has_cap, st);
    }
}

}  // namespace

// The split kernel's grid on the current device for this G, d and these
// types: the SM count times the blocks that fit on one SM.  Writes it to
// *n_blocks; returns a cudaError_t (0 = success).  The caller sizes the
// workspace for B * Hkv + n_blocks - 1 partials.
extern "C" int attn_decode_grid(int G, int d, int q_bf16, int kv_bf16,
                                int* n_blocks) {
    if (G < 1 || G > MAX_G || d < 1 || d > MAX_D)
        return (int)cudaErrorInvalidValue;
    if (q_bf16)
        return kv_bf16 ? grid_t<bf16, bf16>(G, d, n_blocks)
                       : grid_t<bf16, float>(G, d, n_blocks);
    return kv_bf16 ? grid_t<float, bf16>(G, d, n_blocks)
                   : grid_t<float, float>(G, d, n_blocks);
}

// Launches the split kernel on n_blocks persistent blocks and the merge
// kernel on B * Hkv blocks, both on `stream`; returns the first launch
// error's cudaError_t (0 = success).  q_bf16 / kv_bf16: 1 for bfloat16,
// 0 for float32.  Workspaces: ws_ml [P * 2 * G] and ws_acc [P * G * d]
// float32 with P = B * Hkv + n_blocks - 1.  The caller checks dtypes,
// shapes, contiguity, the device, d <= 256 and G <= 16.
extern "C" int attn_decode_launch(
        const void* q, const void* k, const void* v, const int* length,
        void* out, float* ws_ml, float* ws_acc, int B, int Hkv, int G, int d,
        int S, int n_blocks, float scale, float cap, int has_cap,
        int q_bf16, int kv_bf16, void* stream) {
    if (B < 1 || Hkv < 1 || G < 1 || G > MAX_G || d < 1 || d > MAX_D
        || S < 1 || n_blocks < 1 || n_blocks > MAX_BLOCKS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define ATTN_LAUNCH(QT, KT)                                              \
    launch_t<QT, KT>(q, k, v, length, out, ws_ml, ws_acc, B, Hkv, G, d, S, \
                     n_blocks, scale, cap, has_cap, st)
    if (q_bf16)
        return kv_bf16 ? ATTN_LAUNCH(bf16, bf16) : ATTN_LAUNCH(bf16, float);
    return kv_bf16 ? ATTN_LAUNCH(float, bf16) : ATTN_LAUNCH(float, float);
#undef ATTN_LAUNCH
}
