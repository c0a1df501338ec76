// Paged single-token GQA decode attention for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py::paged_decode_kernel
// (body ``_kernel``): one query token per sequence attends over the KV pages
// its block-table row names; f32 online softmax scaled by D^-0.5; slots at
// or past kv_len are masked and pages past kv_len are never read; a row
// with kv_len = 0 gives zeros (l stays 0 and acc / max(l, 1e-30) = 0), as
// the TPU kernel does.
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
// (m, l, acc) in VMEM.  Here one thread block owns one (sequence, KV head):
// it reads its own table row and kv_len, and loops over the live prefix in
// chunks of 64 tokens (several pages at once, so the per-chunk barriers are
// paid once per 64 tokens and not once per page).  Each chunk of K and V is
// gathered page by page into shared memory as f32, and all G query rows of
// the KV head share it: the KV head is read from device memory once, not G
// times.  Scores, the running max and sum, and the accumulator are f32.
// The chunk loads are 16-byte loads, coalesced over D, a thread's loads all
// in flight before its stores; the products run on the FMA units.

#include "kernel_common.cuh"

namespace {

using kernel_common::to_f32;
using kernel_common::from_f32;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 64;  // tokens per chunk (two per lane in the softmax step)
constexpr float M_INIT = -1e30f;

size_t smem_bytes(int G, int D) {
    return sizeof(float) * ((size_t)G * D          // Q rows
                            + (size_t)CH * (D + 1)  // K chunk (padded rows)
                            + (size_t)CH * D        // V chunk
                            + (size_t)G * CH        // scores / probabilities
                            + (size_t)G * D         // accumulator
                            + 3 * (size_t)G);       // max, sum, correction
}

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                    const int* __restrict__ tables, const int* __restrict__ lens,
                    T* __restrict__ o, int KVH, int G, int page, int NB, float scale) {
    constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte load
    constexpr int DV = D / VEC;
    constexpr int NV = CH * DV;                 // 16-byte loads per chunk, each of K and V
    constexpr int PER = (NV + THREADS - 1) / THREADS;
    extern __shared__ __align__(16) float sm[];
    float* Qs = sm;                      // [G][D]
    float* Ks = Qs + G * D;              // [CH][D + 1]
    float* Vs = Ks + CH * (D + 1);       // [CH][D]
    float* Sc = Vs + CH * D;             // [G][CH]
    float* Acc = Sc + G * CH;            // [G][D]
    float* Mx = Acc + G * D;             // [G]
    float* Lx = Mx + G;                  // [G]
    float* Corr = Lx + G;                // [G]

    const int kvh = blockIdx.x;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int H = KVH * G;
    constexpr int LDK = D + 1;
    // a table row covers NB pages; slots past it cannot be valid
    const int len = max(0, min(lens[b], NB * page));
    const int* trow = tables + (int64_t)b * NB;
    const int64_t tok_stride = (int64_t)KVH * D;  // between slots of a page
    const T* qb = q + ((int64_t)b * H + (int64_t)kvh * G) * D;

    for (int i = tid; i < G * D; i += THREADS) {
        Qs[i] = to_f32(qb[i]);
        Acc[i] = 0.f;
    }
    for (int g = tid; g < G; g += THREADS) {
        Mx[g] = M_INIT;
        Lx[g] = 0.f;
    }

    for (int t0 = 0; t0 < len; t0 += CH) {
        __syncthreads();  // the previous chunk's readers are done
        // gather the chunk: every 16-byte load of a thread is issued before
        // any is used, so their latencies overlap
        uint4 kbuf[PER], vbuf[PER];
#pragma unroll
        for (int it = 0; it < PER; ++it) {
            const int i = tid + it * THREADS;
            const int j = i / DV, c = (i % DV) * VEC;
            const int t = t0 + j;
            kbuf[it] = vbuf[it] = make_uint4(0u, 0u, 0u, 0u);
            if (i < NV && t < len) {
                const int64_t slot = (int64_t)trow[t / page] * page + t % page;
                const int64_t off = slot * tok_stride + (int64_t)kvh * D + c;
                kbuf[it] = __ldg(reinterpret_cast<const uint4*>(kp + off));
                vbuf[it] = __ldg(reinterpret_cast<const uint4*>(vp + off));
            }
        }
#pragma unroll
        for (int it = 0; it < PER; ++it) {
            const int i = tid + it * THREADS;
            if (i < NV) {
                const int j = i / DV, c = (i % DV) * VEC;
                const T* ke = reinterpret_cast<const T*>(&kbuf[it]);
                const T* ve = reinterpret_cast<const T*>(&vbuf[it]);
#pragma unroll
                for (int e = 0; e < VEC; ++e) {
                    Ks[j * LDK + c + e] = to_f32(ke[e]);
                    Vs[j * D + c + e] = to_f32(ve[e]);
                }
            }
        }
        __syncthreads();

        for (int i = tid; i < G * CH; i += THREADS) {
            const int g = i / CH, j = i % CH;
            float s = -INFINITY;  // masked slot: exp(-inf) = 0 below
            if (t0 + j < len) {
                const float* qr = Qs + g * D;
                const float* kr = Ks + j * LDK;
                float a = 0.f;
                for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
                s = a * scale;
            }
            Sc[i] = s;
        }
        __syncthreads();

        for (int g = warp; g < G; g += WARPS) {
            float* sr = Sc + g * CH;
            const float a = sr[lane], c = sr[lane + 32];
            const float m_old = Mx[g];
            const float m_new = fmaxf(m_old, warp_max(fmaxf(a, c)));
            const float pa = expf(a - m_new), pc = expf(c - m_new);
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

        for (int i = tid; i < G * D; i += THREADS) {
            const int g = i / D, d = i % D;
            const float* pr = Sc + g * CH;
            float a = Acc[i] * Corr[g];
#pragma unroll 8
            for (int j = 0; j < CH; ++j) a = fmaf(pr[j], Vs[j * D + d], a);
            Acc[i] = a;
        }
    }
    __syncthreads();

    T* ob = o + ((int64_t)b * H + (int64_t)kvh * G) * D;
    for (int i = tid; i < G * D; i += THREADS)
        ob[i] = from_f32<T>(Acc[i] / fmaxf(Lx[i / D], 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* tables, const int* lens,
           void* o, int B, int KVH, int G, int page, int NB, float scale,
           cudaStream_t stream) {
    const size_t smem = smem_bytes(G, D);
    auto kern = paged_decode_kernel<T, D>;
    static kernel_common::SmemGrant grant;  // the size grows with G
    cudaError_t e = grant.ensure(kern, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(KVH, B);
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
        tables, lens, static_cast<T*>(o), KVH, G, page, NB, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* kp, const void* vp, const int* tables,
               const int* lens, void* o, int B, int KVH, int G, int page, int NB, float scale,
               cudaStream_t s) {
    switch (D) {
        case 32: return launch<T, 32>(q, kp, vp, tables, lens, o, B, KVH, G, page, NB, scale, s);
        case 64: return launch<T, 64>(q, kp, vp, tables, lens, o, B, KVH, G, page, NB, scale, s);
        case 128: return launch<T, 128>(q, kp, vp, tables, lens, o, B, KVH, G, page, NB, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  q, o (B, KVH*G, D); k/v pages
// (P, page, KVH, D); tables (B, NB) int32; lens (B,) int32; all contiguous.
// Returns the cudaError_t of the launch (0 on success).
int paged_decode_fwd(int dtype, const void* q, const void* kp, const void* vp,
                     const int* tables, const int* lens, void* o, int B, int KVH, int G,
                     int D, int page, int NB, float scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return dispatch_d<float>(D, q, kp, vp, tables, lens, o, B, KVH, G, page, NB, scale, s);
        case 1: return dispatch_d<__nv_bfloat16>(D, q, kp, vp, tables, lens, o, B, KVH, G, page, NB, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* paged_decode_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

size_t paged_decode_smem_bytes(int G, int D) { return smem_bytes(G, D); }

}  // extern "C"
