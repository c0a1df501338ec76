// Blocked causal GQA flash attention (forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel
// (body ``_kernel``): the same function, queries at absolute positions
// q_offset + i, keys at j, key j visible to query i when j <= q_offset + i
// (causal) and j < Skv; f32 online softmax; output acc / max(l, 1e-30) in
// the input dtype; GQA reads KV head h / (H / KVH).  V's head dim DV may
// differ from the q/k head dim D (MLA: D 96, DV 64); the scale is the
// caller's, D^-0.5 as in the reference.
//
// What bounds it on an H100: at the serve path's shapes (one 128-token
// prompt, 40 heads of 128) it moves ~3 MB and does ~0.2 GFLOP, so device
// memory bounds it at under a microsecond and launch overhead sets the
// time.  At long prompts the QK^T and PV products make it compute bound.
//
// Design.  The TPU kernel walks a sequential grid axis over key blocks and
// carries (m, l, acc) in VMEM scratch between grid steps.  Blocks on a GPU
// run in no order, so here one thread block owns one (b, h, 64-row query
// tile) and loops over 64-key tiles itself, up to the last key its causal
// rows can see (fully masked tiles are never loaded).  Q, K and V tiles
// are staged in shared memory in their own dtype (bf16 halves the bytes
// against f32); scores, running max and sum, and the accumulator stay in
// f32 registers.  128 threads form a 16 x 8 grid: each thread holds a 4 x 8
// block of scores and a 4 x (DV/8) block of the accumulator.  Ragged query
// and key edges are masked in the kernel, so the wrapper makes no padded
// copies; batch and sequence strides come from the caller, so a slice of
// the KV cache is read in place.  Tiles are loaded with 16-byte loads, a
// thread's loads all in flight before its stores.  The products run on
// the FMA units, not the tensor cores: wgmma, TMA and a producer warp are
// later work.

#include "kernel_common.cuh"

namespace {

using kernel_common::to_f32;
using kernel_common::from_f32;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int TX = 8;         // threads across key columns / head dims
constexpr int TY = 16;        // threads across query rows
constexpr int THREADS = TX * TY;
constexpr int RM = BQ / TY;   // query rows per thread
constexpr int CN = BK / TX;   // key columns per thread
constexpr float M_INIT = -1e30f;

// 4 bytes of padding per shared-memory row keeps the row stride an odd
// number of 32-bit words, so threads reading one column of different rows
// hit different banks.
template <typename T> struct RowPad { static constexpr int value = 4 / (int)sizeof(T); };

// Copy ROWS rows of D elements into shared memory (row stride LDS
// elements): global row r starts at src + r * stride, rows at or past
// n_rows read as zero.  16-byte loads, all of a thread's issued before any
// store so that their latencies overlap; the stores go out as 4-byte words
// (padded shared rows are only 4-byte aligned).  Needs src and stride
// aligned to 16 bytes, which the wrapper checks.
template <typename T, int ROWS, int D, int LDS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t stride, int n_rows, int tid) {
    constexpr int VEC = 16 / (int)sizeof(T);
    constexpr int DVEC = D / VEC;  // 16-byte units per row
    constexpr int N = ROWS * DVEC;
    constexpr int PER = (N + THREADS - 1) / THREADS;
    uint4 buf[PER];
#pragma unroll
    for (int it = 0; it < PER; ++it) {
        const int i = tid + it * THREADS;
        const int r = i / DVEC, c = (i % DVEC) * VEC;
        buf[it] = make_uint4(0u, 0u, 0u, 0u);
        if (i < N && r < n_rows) buf[it] = __ldg(reinterpret_cast<const uint4*>(src + r * stride + c));
    }
#pragma unroll
    for (int it = 0; it < PER; ++it) {
        const int i = tid + it * THREADS;
        if (i < N) {
            const int r = i / DVEC, c = (i % DVEC) * VEC;
            uint32_t* d32 = reinterpret_cast<uint32_t*>(dst + r * LDS + c);
            d32[0] = buf[it].x;
            d32[1] = buf[it].y;
            d32[2] = buf[it].z;
            d32[3] = buf[it].w;
        }
    }
}

template <typename T, int D, int DV>
constexpr size_t smem_bytes() {
    return (size_t)(BQ + BK) * (D + RowPad<T>::value) * sizeof(T)   // Q, K tiles
         + (size_t)BK * DV * sizeof(T)                          // V tile
         + (size_t)BQ * (BK + 1) * sizeof(float);               // P tile
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int KVH, int Sq, int Skv,
                 int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                 int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                 int causal, int q_offset, float scale) {
    constexpr int LD = D + RowPad<T>::value;
    constexpr int DN = DV / TX;         // accumulator columns per thread
    constexpr int PL = BK + 1;          // P tile row stride (floats)
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* Qs = reinterpret_cast<T*>(smem_raw);
    T* Ks = Qs + BQ * LD;
    T* Vs = Ks + BK * LD;
    float* Ps = reinterpret_cast<float*>(Vs + BK * DV);

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kvh = h / (H / KVH);
    const int tid = threadIdx.x;
    const int ty = tid / TX;
    const int tx = tid % TX;

    const T* qb = q + b * q_sb + (int64_t)h * D;
    const T* kb = k + b * k_sb + (int64_t)kvh * D;
    const T* vb = v + b * v_sb + (int64_t)kvh * DV;
    T* ob = o + b * o_sb + (int64_t)h * DV;

    load_tile<T, BQ, D, LD>(Qs, qb + (int64_t)q0 * q_ss, q_ss, Sq - q0, tid);

    float m[RM], l[RM], acc[RM][DN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        m[i] = M_INIT;
        l[i] = 0.f;
#pragma unroll
        for (int n = 0; n < DN; ++n) acc[i][n] = 0.f;
    }

    // keys this tile's rows can see: causal rows stop at their own position
    int kv_end = Skv;
    if (causal) {
        const int last_row = min(q0 + BQ, Sq) - 1;
        kv_end = min(Skv, q_offset + last_row + 1);
    }

    for (int k0 = 0; k0 < kv_end; k0 += BK) {
        __syncthreads();  // the previous tile's readers are done with K, V, P
        load_tile<T, BK, D, LD>(Ks, kb + (int64_t)k0 * k_ss, k_ss, Skv - k0, tid);
        load_tile<T, BK, DV, DV>(Vs, vb + (int64_t)k0 * v_ss, v_ss, Skv - k0, tid);
        __syncthreads();

        float s[RM][CN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            float qv[RM], kv[CN];
#pragma unroll
            for (int i = 0; i < RM; ++i) qv[i] = to_f32(Qs[(ty * RM + i) * LD + d]);
#pragma unroll
            for (int j = 0; j < CN; ++j) kv[j] = to_f32(Ks[(tx + TX * j) * LD + d]);
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

        // online softmax; the 8 threads of a row are 8 consecutive lanes
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const int qpos = q_offset + q0 + ty * RM + i;
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < CN; ++j) {
                const int kpos = k0 + tx + TX * j;
                const bool vis = kpos < Skv && (!causal || kpos <= qpos);
                s[i][j] = vis ? s[i][j] * scale : -INFINITY;
                mx = fmaxf(mx, s[i][j]);
            }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
            const float m_new = fmaxf(m[i], mx);
            const float corr = expf(m[i] - m_new);
            float psum = 0.f;
#pragma unroll
            for (int j = 0; j < CN; ++j) {
                const float p = expf(s[i][j] - m_new);  // masked: exp(-inf) = 0
                Ps[(ty * RM + i) * PL + tx + TX * j] = p;
                psum += p;
            }
            psum += __shfl_xor_sync(0xffffffffu, psum, 1);
            psum += __shfl_xor_sync(0xffffffffu, psum, 2);
            psum += __shfl_xor_sync(0xffffffffu, psum, 4);
            l[i] = l[i] * corr + psum;
            m[i] = m_new;
#pragma unroll
            for (int n = 0; n < DN; ++n) acc[i][n] *= corr;
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            float pv[RM], vv[DN];
#pragma unroll
            for (int i = 0; i < RM; ++i) pv[i] = Ps[(ty * RM + i) * PL + c];
#pragma unroll
            for (int n = 0; n < DN; ++n) vv[n] = to_f32(Vs[c * DV + tx + TX * n]);
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int n = 0; n < DN; ++n) acc[i][n] = fmaf(pv[i], vv[n], acc[i][n]);
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int row = q0 + ty * RM + i;
        if (row < Sq) {
            const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
            for (int n = 0; n < DN; ++n)
                ob[(int64_t)row * o_ss + tx + TX * n] = from_f32<T>(acc[i][n] / denom);
        }
    }
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KVH,
           int Sq, int Skv, const int64_t* st, int causal, int q_offset, float scale,
           cudaStream_t stream) {
    const size_t smem = smem_bytes<T, D, DV>();
    auto kern = flash_fwd_kernel<T, D, DV>;
    static kernel_common::SmemGrant grant;  // one size per instantiation
    cudaError_t e = grant.ensure(kern, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), H, KVH, Sq, Skv, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], causal, q_offset, scale);
    return (int)cudaGetLastError();
}

// (D, DV) pairs with an instance: D = DV at 32, 64 and 128, and MLA's (96, 64).
template <typename T>
int dispatch_d(int D, int DV, const void* q, const void* k, const void* v, void* o, int B, int H,
               int KVH, int Sq, int Skv, const int64_t* st, int causal, int q_offset,
               float scale, cudaStream_t stream) {
    if (D == 32 && DV == 32)
        return launch<T, 32, 32>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, q_offset, scale, stream);
    if (D == 64 && DV == 64)
        return launch<T, 64, 64>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, q_offset, scale, stream);
    if (D == 128 && DV == 128)
        return launch<T, 128, 128>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, q_offset, scale, stream);
    if (D == 96 && DV == 64)
        return launch<T, 96, 64>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, q_offset, scale, stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  q (B, Sq, H, D), k (B, Skv, KVH, D),
// v (B, Skv, KVH, DV) and o (B, Sq, H, DV), each with unit stride over its
// head dim and that head dim as its stride over heads; strides = {q_b, q_s,
// k_b, k_s, v_b, v_s, o_b, o_s} in elements.  Returns the cudaError_t of
// the launch (0 on success).
int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KVH, int Sq, int Skv, int D, int DV,
                        const int64_t* strides, int causal, int q_offset, float scale,
                        void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return dispatch_d<float>(D, DV, q, k, v, o, B, H, KVH, Sq, Skv, strides, causal, q_offset, scale, s);
        case 1: return dispatch_d<__nv_bfloat16>(D, DV, q, k, v, o, B, H, KVH, Sq, Skv, strides, causal, q_offset, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* flash_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
