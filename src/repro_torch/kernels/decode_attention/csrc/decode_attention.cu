// Paged single-token GQA decode attention for Hopper, sm_90a, split over
// the KV range.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py::paged_decode_kernel
// (body ``_kernel``): one query token per sequence attends over the KV pages
// its block-table row names; f32 online softmax scaled by D^-0.5; slots at
// or past kv_len are masked and pages past kv_len are never read; a row
// with kv_len = 0 gives zeros, as the TPU kernel does.
//
// What bounds it on an H100: every K and V byte of the live prefix is read
// once and used for only G (= H / KVH) query rows, about 2G flops per
// 2-byte element, far below the ~295 flops per byte where the tensor cores
// would become the limit.  Device memory bounds it; at the serve path's
// shape (one sequence of ~136 tokens) it moves ~0.6 MB and launch overhead
// sets the time.
//
// Design.  The TPU kernel prefetches the block table into SMEM (scalar
// prefetch) and lets a sequential grid axis walk the pages, carrying
// (m, l, acc) in VMEM.  One block per (sequence, KV head) would give 8
// blocks on 132 SMs at the serve shape, and one block's serial walk over
// the longest sequence would set a batch's tail; so each (sequence, KV
// head)'s slot range is cut into n_splits ranges of split_len slots, which
// the host picks from the table's width, B·KVH and the SM count
// (``ops.py::split_plan``), never from kv_len, so no launch waits on the
// device.  Two kernels behind one entry point:
//
// The split kernel, one block per (split, KV head, sequence), reads its own
// table row and kv_len; a range that starts at or past kv_len writes l = 0
// and exits.  It walks its range in chunks of 64 tokens, gathered page by
// page by cp.async (16 bytes a copy, every copy's table lookup issued
// before the copies, slots past the range zero-filled) into a ring of two
// shared-memory stages in the input dtype, chunk c+1 in flight while chunk
// c computes.  A slot's address comes from the page and slot strides the
// wrapper passes, so the pages may be a strided view of a larger cache (a
// rank's KV heads under a split over model) and are never copied.  All G
// query rows of the KV head share each load.  It writes
// its unnormalised partial (m, l, acc[G][D]) in f32 to scratch the wrapper
// allocates.  Two instances:
//
// bf16 (paged_decode_mma_kernel, below): the products on the tensor cores,
// mma.sync m16n8k16 over 16 query rows, a G under 16 padded with zero rows
// and a G over 16 cut into groups of 16, a block each; each warp takes 16
// tokens of a chunk with its own online softmax, and the four warps are
// joined once at the end of the range.
//
// f32 (paged_decode_split_kernel): FMA units.
// Scores: a warp takes 32 / LPT tokens at a time, LPT lanes to a token
// (the K row's 16-byte pieces rounded up to a power of 2: 28 pieces of
// head dim 112 take 32 lanes, 4 of them idle), each lane one piece, the G
// dot products joined by shuffles.  P·V: a thread owns a pair of output
// dims of one query row and walks the chunk's tokens.
//
// Head dims (instances at the end): 32, 64, 112 (kimi-k2's 7168 / 64:
// 7 k-steps of 16 and 14 n-tiles of 8 in the bf16 kernel) and 128.
//
// paged_decode_join_kernel, one block per (query row, KV head, sequence):
// joins the partials with the usual rescale, acc = sum_s e^(m_s - M) acc_s over the
// splits with l_s > 0, divided by max(l, 1e-30); no such split gives zeros.

#include "kernel_common.cuh"
#include "mma_split.cuh"

#include <type_traits>

namespace {

using kernel_common::from_f32;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 64;  // tokens per chunk (two per lane in the softmax step)
constexpr float M_INIT = -1e30f;

size_t split_smem_bytes(int G, int D) {
    return 2 * 2 * (size_t)CH * D * sizeof(float)      // K and V, two stages
         + sizeof(float) * ((size_t)G * D              // Q rows
                            + (size_t)G * CH           // scores / probabilities
                            + (size_t)G * D            // accumulator
                            + 3 * (size_t)G);          // max, sum, correction
}

size_t join_smem_bytes(int n_splits) { return sizeof(float) * (size_t)n_splits; }

// n rounded up to a power of 2
__host__ __device__ constexpr int pow2_ceil(int n) { return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// part_ml: (B, KVH, n_splits, G, 2) f32 {m, l}; part_acc: (B, KVH, n_splits, G, D) f32.
// ps, ss: the page and slot strides of k and v, which share them.
template <int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_split_kernel(const float* __restrict__ q, const float* __restrict__ kp, const float* __restrict__ vp,
                          const int* __restrict__ tables, const int* __restrict__ lens,
                          float* __restrict__ part_ml, float* __restrict__ part_acc,
                          int KVH, int G, int page, int NB, int split_len, float scale,
                          int64_t ps, int64_t ss) {
    constexpr int VEC = 4;                     // elements per 16-byte copy
    constexpr int CPR = D / VEC;               // copies (16-byte pieces) per token row
    constexpr int LPT = pow2_ceil(CPR);        // lanes per token row in the scores
    constexpr int TPW = 32 / LPT;              // tokens a warp takes at once
    constexpr int NCP = CH * CPR;              // copies per chunk, each of K and V
    static_assert(D % VEC == 0 && LPT <= 32, "a token row's pieces fit one warp");
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* Ks = reinterpret_cast<float*>(smem_raw);  // [2][CH][D]
    float* Vs = Ks + 2 * CH * D;               // [2][CH][D]
    float* Qs = Vs + 2 * CH * D;               // [G][D]
    float* Sc = Qs + G * D;                    // [G][CH]
    float* Acc = Sc + G * CH;                  // [G][D]
    float* Mx = Acc + G * D;                   // [G]
    float* Lx = Mx + G;                        // [G]
    float* Corr = Lx + G;                      // [G]

    const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int n_splits = gridDim.x;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int H = KVH * G;
    // a table row covers NB pages; slots past it cannot be valid
    const int len = max(0, min(lens[b], NB * page));
    const int t_begin = split * split_len;
    const int t_end = min(t_begin + split_len, len);
    const int64_t pidx = (((int64_t)b * KVH + kvh) * n_splits + split) * G;
    if (t_begin >= t_end) {  // an empty range: l = 0, the join skips it
        for (int g = tid; g < G; g += THREADS) {
            part_ml[(pidx + g) * 2] = M_INIT;
            part_ml[(pidx + g) * 2 + 1] = 0.f;
        }
        return;
    }
    const int* trow = tables + (int64_t)b * NB;
    // The pages may be a strided view (a rank's KV heads of a whole cache,
    // under a split over model): slot t's row starts trow[t / page] * ps +
    // (t % page) * ss elements into k or v (ps, ss: the page and slot
    // strides the wrapper reads off k and v, which must share them), and
    // head kvh D elements further, heads and head dims being contiguous.
    // For contiguous pages ps = page * KVH * D and ss = KVH * D.
    const float* kb = kp + (int64_t)kvh * D;
    const float* vb = vp + (int64_t)kvh * D;

    // gather a chunk: every copy's slot is looked up before any copy is
    // issued, so the table reads overlap
    auto issue = [&](int t0, int st) {
        constexpr int PER = (NCP + THREADS - 1) / THREADS;
        float* kd = Ks + st * CH * D;
        float* vd = Vs + st * CH * D;
        int64_t off[PER];
#pragma unroll
        for (int it = 0; it < PER; ++it) {
            const int i = tid + it * THREADS;
            const int t = t0 + i / CPR;
            off[it] = -1;
            if (i < NCP && t < t_end) off[it] = (int64_t)trow[t / page] * ps + (int64_t)(t % page) * ss;
        }
#pragma unroll
        for (int it = 0; it < PER; ++it) {
            const int i = tid + it * THREADS;
            if (i < NCP) {
                const int j = i / CPR, c = (i % CPR) * VEC;
                const bool ok = off[it] >= 0;
                kernel_common::cp_async16(kd + j * D + c, ok ? kb + off[it] + c : kb, ok ? 16 : 0);
                kernel_common::cp_async16(vd + j * D + c, ok ? vb + off[it] + c : vb, ok ? 16 : 0);
            }
        }
    };
    issue(t_begin, 0);
    kernel_common::cp_async_commit();

    const float* qb = q + ((int64_t)b * H + (int64_t)kvh * G) * D;
    for (int i = tid; i < G * D; i += THREADS) {
        Qs[i] = qb[i];
        Acc[i] = 0.f;
    }
    for (int g = tid; g < G; g += THREADS) {
        Mx[g] = M_INIT;
        Lx[g] = 0.f;
    }

    const int n_chunks = (t_end - t_begin + CH - 1) / CH;
    const int sub = lane / LPT, part = lane % LPT;
    const bool piece = part < CPR;  // false: a lane past the row's pieces adds 0
    for (int ci = 0; ci < n_chunks; ++ci) {
        const int t0 = t_begin + ci * CH, st = ci % 2;
        const int n_valid = min(CH, t_end - t0);
        __syncthreads();  // chunk ci-1's readers are done with its stage
        if (ci + 1 < n_chunks) issue(t0 + CH, st ^ 1);
        kernel_common::cp_async_commit();
        kernel_common::cp_async_wait<1>();
        __syncthreads();  // chunk ci has landed for every thread

        const float* kc = Ks + st * CH * D;
        const float* vc = Vs + st * CH * D;
        // scores: LPT lanes per token, one 16-byte piece of the K row each
        for (int j0 = warp * TPW; j0 < CH; j0 += WARPS * TPW) {
            const int j = j0 + sub;
            float4 k4 = make_float4(0.f, 0.f, 0.f, 0.f);
            if (piece) k4 = *reinterpret_cast<const float4*>(kc + j * D + part * VEC);
            const float kf[VEC] = {k4.x, k4.y, k4.z, k4.w};
            for (int g = 0; g < G; ++g) {
                const float* qr = Qs + g * D + part * VEC;
                float a = 0.f;
                if (piece) {
#pragma unroll
                    for (int e = 0; e < VEC; ++e) a = fmaf(qr[e], kf[e], a);
                }
#pragma unroll
                for (int off = LPT / 2; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
                if (part == 0) Sc[g * CH + j] = j < n_valid ? a * scale : -INFINITY;
            }
        }
        __syncthreads();

        for (int g = warp; g < G; g += WARPS) {
            float* sr = Sc + g * CH;
            const float a = sr[lane], c = sr[lane + 32];
            const float m_old = Mx[g];
            const float m_new = fmaxf(m_old, warp_max(fmaxf(a, c)));
            const float pa = expf(a - m_new), pc = expf(c - m_new);  // masked: exp(-inf) = 0
            sr[lane] = pa;
            sr[lane + 32] = pc;
            const float sum = warp_sum(pa + pc);
            if (lane == 0) {
                const float corr = expf(m_old - m_new);
                Corr[g] = corr;
                Lx[g] = Lx[g] * corr + sum;
                Mx[g] = m_new;
            }
        }
        __syncthreads();

        for (int i = tid; i < G * (D / 2); i += THREADS) {
            const int g = i / (D / 2), d = 2 * (i % (D / 2));
            const float* pr = Sc + g * CH;
            const float corr = Corr[g];
            float a0 = Acc[g * D + d] * corr, a1 = Acc[g * D + d + 1] * corr;
            for (int j = 0; j < n_valid; ++j) {
                const float p = pr[j];
                const float2 vv = *reinterpret_cast<const float2*>(vc + j * D + d);
                a0 = fmaf(p, vv.x, a0);
                a1 = fmaf(p, vv.y, a1);
            }
            Acc[g * D + d] = a0;
            Acc[g * D + d + 1] = a1;
        }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += THREADS) part_acc[pidx * D + i] = Acc[i];
    for (int g = tid; g < G; g += THREADS) {
        part_ml[(pidx + g) * 2] = Mx[g];
        part_ml[(pidx + g) * 2 + 1] = Lx[g];
    }
}

// a block-wide max or sum of one value per thread; ``red`` holds WARPS floats
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
    x = MAX ? warp_max(x) : warp_sum(x);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    __syncthreads();  // red is free
    if (lane == 0) red[warp] = x;
    __syncthreads();
    x = red[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) x = MAX ? fmaxf(x, red[w]) : x + red[w];
    return x;
}

// one block per (query row g, KV head, sequence); threads walk the splits
// to find the join's max and sum, then the head dims
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_join_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                         T* __restrict__ o, int KVH, int G, int D, int n_splits) {
    extern __shared__ float W[];  // [n_splits]: e^(m_s - M), 0 for an empty split
    __shared__ float red[WARPS];
    const int g = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
    const int64_t base = ((int64_t)b * KVH + kvh) * n_splits;  // split 0 of this (b, kvh)
    float M = M_INIT;
    for (int s = tid; s < n_splits; s += THREADS) {
        const float2 ml = *reinterpret_cast<const float2*>(part_ml + ((base + s) * G + g) * 2);
        if (ml.y > 0.f) M = fmaxf(M, ml.x);
    }
    M = block_reduce<true>(M, red);
    float L = 0.f;
    for (int s = tid; s < n_splits; s += THREADS) {
        const float2 ml = *reinterpret_cast<const float2*>(part_ml + ((base + s) * G + g) * 2);
        const float w = ml.y > 0.f ? expf(ml.x - M) : 0.f;
        W[s] = w;
        L += w * ml.y;
    }
    L = block_reduce<false>(L, red);  // its barriers also publish W
    const float inv = 1.f / fmaxf(L, 1e-30f);
    T* ob = o + (((int64_t)b * KVH + kvh) * G + g) * D;
    for (int d = tid; d < D; d += THREADS) {
        float a = 0.f;
#pragma unroll 8
        for (int s = 0; s < n_splits; ++s) {
            const float w = W[s];
            if (w > 0.f) a = fmaf(w, part_acc[((base + s) * G + g) * D + d], a);
        }
        ob[d] = from_f32<T>(a * inv);
    }
}

// ------------------------------------------------------- bf16: mma.sync
// The split kernel again, with its products on the tensor cores.  A group
// of up to 16 of a KV head's G query rows (blockIdx.y = kvh * n_groups +
// group), padded with zero rows to 16, is the A operand of mma.sync
// m16n8k16 (held in registers for the whole range); each warp
// takes 16 tokens of every 64-token chunk and keeps its own online softmax
// over them: S = Q·Kᵀ (16 x 16), P split into bf16 P_hi and P_lo as in the
// flash kernel (a P rounded to bf16 alone would lose 2^-9 per term), and
// P·V into an f32 accumulator of 16 x D.  K and V rows are padded by 16
// bytes in shared memory so that the fragment loads hit 32 distinct banks;
// V is read transposed by ldmatrix.  No barrier inside a chunk: the four
// warps' partials are joined once, at the end of the range.
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int CH = 64;       // tokens per chunk, 16 per warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D> struct Layout {
    static constexpr int LD = D + 8;                             // padded row, elements
    static constexpr int STAGE = CH * LD;                        // elements, each of K and V
    static constexpr size_t SMEM = 2 * 2 * (size_t)STAGE * sizeof(bf16);
    static_assert((size_t)WARPS * 16 * D * sizeof(float) <= SMEM, "the join buffer reuses the stages");
};

using mma_split::mma16816;

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp, const bf16* __restrict__ vp,
                        const int* __restrict__ tables, const int* __restrict__ lens,
                        float* __restrict__ part_ml, float* __restrict__ part_acc,
                        int KVH, int G, int page, int NB, int split_len, float scale,
                        int64_t ps, int64_t ss) {
    using L = Layout<D>;
    constexpr int LPT = D / 8;          // 16-byte copies per token row
    constexpr int NCP = CH * LPT;       // copies per chunk, each of K and V
    constexpr int PER = NCP / THREADS;
    constexpr int NT = D / 8;           // n-tiles of the accumulator
    static_assert(D % 16 == 0 && NCP % THREADS == 0, "k-steps of 16; every thread a whole number of copies");
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [2][CH][LD]
    bf16* Vs = Ks + 2 * L::STAGE;                  // [2][CH][LD]
    __shared__ float Mw[WARPS][16], Lw[WARPS][16];

    const int n_groups = (G + 15) / 16;
    const int split = blockIdx.x, kvh = blockIdx.y / n_groups, b = blockIdx.z;
    const int g0 = (blockIdx.y % n_groups) * 16, GB = min(16, G - g0);  // this block's rows
    const int n_splits = gridDim.x;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int gr = lane / 4, gc = lane % 4;  // fragment row and column pair
    const int H = KVH * G;
    const int len = max(0, min(lens[b], NB * page));
    const int t_begin = split * split_len;
    const int t_end = min(t_begin + split_len, len);
    const int64_t pidx = (((int64_t)b * KVH + kvh) * n_splits + split) * G + g0;
    if (t_begin >= t_end) {
        for (int g = tid; g < GB; g += THREADS) {
            part_ml[(pidx + g) * 2] = M_INIT;
            part_ml[(pidx + g) * 2 + 1] = 0.f;
        }
        return;
    }
    const int* trow = tables + (int64_t)b * NB;
    // slot offsets from the page and slot strides, as in the f32 kernel
    const bf16* kb = kp + (int64_t)kvh * D;
    const bf16* vb = vp + (int64_t)kvh * D;

    auto issue = [&](int t0, int st) {
        bf16* kd = Ks + st * L::STAGE;
        bf16* vd = Vs + st * L::STAGE;
        int64_t off[PER];
#pragma unroll
        for (int it = 0; it < PER; ++it) {
            const int t = t0 + (tid + it * THREADS) / LPT;
            off[it] = t < t_end ? (int64_t)trow[t / page] * ps + (int64_t)(t % page) * ss : -1;
        }
#pragma unroll
        for (int it = 0; it < PER; ++it) {
            const int i = tid + it * THREADS;
            const int j = i / LPT, c = (i % LPT) * 8;
            const bool ok = off[it] >= 0;
            kernel_common::cp_async16(kd + j * L::LD + c, ok ? kb + off[it] + c : kb, ok ? 16 : 0);
            kernel_common::cp_async16(vd + j * L::LD + c, ok ? vb + off[it] + c : vb, ok ? 16 : 0);
        }
    };
    issue(t_begin, 0);
    kernel_common::cp_async_commit();

    // Q rows g < GB as A fragments, zero rows past GB
    const bf16* qb = q + ((int64_t)b * H + (int64_t)kvh * G + g0) * D;
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int k0 = kk * 16 + 2 * gc;
        auto ld = [&](int row, int col) {
            return row < GB ? *reinterpret_cast<const uint32_t*>(qb + row * D + col) : 0u;
        };
        qa[kk][0] = ld(gr, k0);
        qa[kk][1] = ld(gr + 8, k0);
        qa[kk][2] = ld(gr, k0 + 8);
        qa[kk][3] = ld(gr + 8, k0 + 8);
    }
    const float sl2 = scale * LOG2E;
    float m_lo = M_INIT, m_hi = M_INIT, l_lo = 0.f, l_hi = 0.f;  // rows gr, gr + 8; l: this thread's columns
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    const int n_chunks = (t_end - t_begin + CH - 1) / CH;
    for (int ci = 0; ci < n_chunks; ++ci) {
        const int t0 = t_begin + ci * CH, st = ci % 2;
        const int n_valid = min(CH, t_end - t0);
        __syncthreads();  // chunk ci-1's readers are done with its stage
        if (ci + 1 < n_chunks) issue(t0 + CH, st ^ 1);
        kernel_common::cp_async_commit();
        kernel_common::cp_async_wait<1>();
        __syncthreads();  // chunk ci has landed for every thread
        const int w0 = warp * 16;  // this warp's tokens in the chunk
        if (w0 >= n_valid) continue;

        const bf16* kc = Ks + st * L::STAGE;
        const bf16* vc = Vs + st * L::STAGE;
        float s[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
            const bf16* kr = kc + (w0 + nt * 8 + gr) * L::LD + 2 * gc;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                mma16816(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                         *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
        }
        float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = w0 + nt * 8 + 2 * gc + (e & 1);
                const float x = j < n_valid ? s[nt][e] * sl2 : -INFINITY;
                s[nt][e] = x;
                if (e < 2) mx_lo = fmaxf(mx_lo, x);
                else mx_hi = fmaxf(mx_hi, x);
            }
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
        const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
        const float c_lo = exp2f(m_lo - mn_lo), c_hi = exp2f(m_hi - mn_hi);
        m_lo = mn_lo;
        m_hi = mn_hi;
        float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = exp2f(s[nt][e] - (e < 2 ? mn_lo : mn_hi));  // masked: 0
                s[nt][e] = p;
                if (e < 2) sum_lo += p;
                else sum_hi += p;
            }
        l_lo = l_lo * c_lo + sum_lo;
        l_hi = l_hi * c_hi + sum_hi;
        // P (16 rows x this warp's 16 tokens) as an A operand, hi and lo
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const float p0 = s[r / 2][2 * (r % 2)], p1 = s[r / 2][2 * (r % 2) + 1];
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
            ph[r] = *reinterpret_cast<const uint32_t*>(&h2);
            pl[r] = pack(p0 - __low2float(h2), p1 - __high2float(h2));
        }
        // ldmatrix.trans: lane l reads token w0 + 8 * ((l / 8) % 2) + l % 8,
        // dims 8 * (l / 16) of each 16-dim pair of n-tiles
        const bf16* vr = vc + (w0 + 8 * ((lane / 8) % 2) + lane % 8) * L::LD + 8 * (lane / 16);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
            uint32_t vf[4];
            ldmatrix_x4_trans(vf, vr + np * 16);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float (&a)[4] = acc[2 * np + h];
                a[0] *= c_lo;
                a[1] *= c_lo;
                a[2] *= c_hi;
                a[3] *= c_hi;
                mma16816(a, ph, vf[2 * h], vf[2 * h + 1]);
                mma16816(a, pl, vf[2 * h], vf[2 * h + 1]);
            }
        }
    }
    kernel_common::cp_async_wait<0>();
    __syncthreads();  // every warp is done with the stages: they hold the join buffer now

    // join the four warps' partials over rows g < GB
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
    if (gc == 0) {
        Mw[warp][gr] = m_lo;
        Mw[warp][gr + 8] = m_hi;
        Lw[warp][gr] = l_lo;
        Lw[warp][gr + 8] = l_hi;
    }
    float* red = reinterpret_cast<float*>(smem_raw);  // [WARPS][16][D]
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        const int d = 8 * n + 2 * gc;
        float* r0 = red + (warp * 16 + gr) * D + d;
        r0[0] = acc[n][0];
        r0[1] = acc[n][1];
        r0[8 * D] = acc[n][2];
        r0[8 * D + 1] = acc[n][3];
    }
    __syncthreads();
    for (int i = tid; i < GB * D; i += THREADS) {
        const int g = i / D, d = i % D;
        float M = Mw[0][g];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) M = fmaxf(M, Mw[w][g]);
        float a = 0.f, l = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const float f = exp2f(Mw[w][g] - M);  // a warp that saw no token: 0
            a += f * red[(w * 16 + g) * D + d];
            l += f * Lw[w][g];
        }
        part_acc[pidx * D + i] = a;
        if (d == 0) {
            part_ml[(pidx + g) * 2] = M * LN2;  // natural-log units, as the join reads them
            part_ml[(pidx + g) * 2 + 1] = l;
        }
    }
}

}  // namespace tc

// the join kernel is one function per dtype, shared by every head dim
template <typename T>
kernel_common::SmemGrant& join_grant() {
    static kernel_common::SmemGrant grant;
    return grant;
}

// the split kernel each dtype runs: bf16 on the tensor cores, f32 on the
// FMA units (launch() branches on it, paged_decode_design reports it)
template <typename T> constexpr bool kTensorCores = std::is_same_v<T, __nv_bfloat16>;

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* tables, const int* lens,
           float* part_ml, float* part_acc, void* o, int B, int KVH, int G, int page, int NB,
           int n_splits, int split_len, float scale, int64_t ps, int64_t ss, cudaStream_t stream) {
    cudaError_t e;
    if constexpr (kTensorCores<T>) {
        auto kern = tc::paged_decode_mma_kernel<D>;
        static kernel_common::SmemGrant grant;
        e = grant.ensure(kern, tc::Layout<D>::SMEM);
        if (e != cudaSuccess) return (int)e;
        kern<<<dim3(n_splits, KVH * ((G + 15) / 16), B), THREADS, tc::Layout<D>::SMEM, stream>>>(
            static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
            static_cast<const __nv_bfloat16*>(vp), tables, lens, part_ml, part_acc, KVH, G, page, NB,
            split_len, scale, ps, ss);
    } else {
        const size_t smem = split_smem_bytes(G, D);
        auto kern = paged_decode_split_kernel<D>;
        static kernel_common::SmemGrant grant;  // the size grows with G
        e = grant.ensure(kern, smem);
        if (e != cudaSuccess) return (int)e;
        kern<<<dim3(n_splits, KVH, B), THREADS, smem, stream>>>(
            static_cast<const float*>(q), static_cast<const float*>(kp), static_cast<const float*>(vp),
            tables, lens, part_ml, part_acc, KVH, G, page, NB, split_len, scale, ps, ss);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const size_t jsmem = join_smem_bytes(n_splits);
    auto join = paged_decode_join_kernel<T>;
    e = join_grant<T>().ensure(join, jsmem);
    if (e != cudaSuccess) return (int)e;
    join<<<dim3(G, KVH, B), THREADS, jsmem, stream>>>(part_ml, part_acc, static_cast<T*>(o), KVH, G, D, n_splits);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* kp, const void* vp, const int* tables,
               const int* lens, float* part_ml, float* part_acc, void* o, int B, int KVH, int G,
               int page, int NB, int n_splits, int split_len, float scale, int64_t ps, int64_t ss,
               cudaStream_t s) {
    switch (D) {
        case 32: return launch<T, 32>(q, kp, vp, tables, lens, part_ml, part_acc, o, B, KVH, G, page, NB, n_splits, split_len, scale, ps, ss, s);
        case 64: return launch<T, 64>(q, kp, vp, tables, lens, part_ml, part_acc, o, B, KVH, G, page, NB, n_splits, split_len, scale, ps, ss, s);
        case 112: return launch<T, 112>(q, kp, vp, tables, lens, part_ml, part_acc, o, B, KVH, G, page, NB, n_splits, split_len, scale, ps, ss, s);
        case 128: return launch<T, 128>(q, kp, vp, tables, lens, part_ml, part_acc, o, B, KVH, G, page, NB, n_splits, split_len, scale, ps, ss, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  q, o (B, KVH*G, D), tables (B, NB) int32
// and lens (B,) int32 contiguous; k/v pages (P, page, KVH, D), contiguous
// over (KVH, D) and starting on 16 bytes, at the strides ``strides`` gives
// (host memory, in elements, each a whole number of 16 bytes): {k page,
// k slot, v page, v slot}, v's equal to k's (cudaErrorInvalidValue else).
// part_ml (B, KVH, n_splits, G, 2) and part_acc (B, KVH, n_splits, G, D)
// f32 scratch; split s covers slots [s*split_len, (s+1)*split_len).
// Returns the cudaError_t of the launches (0 on success).
int paged_decode_fwd(int dtype, const void* q, const void* kp, const void* vp,
                     const int* tables, const int* lens, float* part_ml, float* part_acc, void* o,
                     int B, int KVH, int G, int D, int page, int NB, int n_splits, int split_len,
                     const int64_t* strides, float scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (strides[0] != strides[2] || strides[1] != strides[3]) return (int)cudaErrorInvalidValue;
    const int64_t ps = strides[0], ss = strides[1];
    switch (dtype) {
        case 0: return dispatch_d<float>(D, q, kp, vp, tables, lens, part_ml, part_acc, o, B, KVH, G, page, NB, n_splits, split_len, scale, ps, ss, s);
        case 1: return dispatch_d<__nv_bfloat16>(D, q, kp, vp, tables, lens, part_ml, part_acc, o, B, KVH, G, page, NB, n_splits, split_len, scale, ps, ss, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* paged_decode_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// shared memory one split block needs (dtype as above); a head dim with
// no instance answers SIZE_MAX, so it is never taken to fit
size_t paged_decode_smem_bytes(int dtype, int G, int D) {
    size_t mma;
    switch (D) {
        case 32: mma = tc::Layout<32>::SMEM; break;
        case 64: mma = tc::Layout<64>::SMEM; break;
        case 112: mma = tc::Layout<112>::SMEM; break;
        case 128: mma = tc::Layout<128>::SMEM; break;
        default: return SIZE_MAX;
    }
    return dtype == 0 ? split_smem_bytes(G, D) : mma;
}

// the split kernel's design for a dtype (as above), the name chip_smoke.py prints
const char* paged_decode_design(int dtype) {
    const bool tensor_cores = dtype == 0 ? kTensorCores<float> : kTensorCores<__nv_bfloat16>;
    return tensor_cores ? "mma.sync_m16n8k16" : "fma";
}

}  // extern "C"
