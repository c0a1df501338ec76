// RWKV6 WKV scan (forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6/rwkv6.py::wkv_kernel (body ``_kernel``)
// and computes the same function as the model's scan
//   src/repro/models/ssm.py::wkv_chunked:
//     y_t = r_t · (S + (u ∘ k_t) v_tᵀ),   S ← diag(w_t) S + k_t v_tᵀ
// in the chunked closed form, with the per-token log-decay clamped at
// -80 / chunk.  The clamp makes the chunk length part of the function, so
// the chunk is an argument (the model runs 16, the reference op 32).
// r/k/v arrive as bf16 or f32, w/u/state as f32; all arithmetic is f32;
// y goes out in f32 and the final state is written once.
//
// What bounds it on an H100: per chunk of C steps and head size N it does
// about 4·C·N² + 2·C²·N flops per (b, h) on C·N·(3 + 1) inputs, so at the
// model's shapes (C 16, N 64) it is ~17 flops per byte: memory and the
// serial chunk loop bound it, not the multipliers.
//
// Design.  The TPU kernel walks a sequential grid axis over chunks and
// keeps the N x N state in VMEM scratch.  GPU blocks run in no order, so
// here one thread block owns one (b, h) and loops over the chunks itself;
// the state stays in shared memory for the whole sequence and touches
// device memory twice (read at the start, written at the end).  Per chunk:
// load r, k, v and the clamped log w (steps past S read as r = k = v = 0,
// w = 1, the reference's padding, so the wrapper copies nothing); inclusive
// cumulative log-decay per channel; r_dec = r·exp(cum_prev),
// k_inv = k·exp(-cum), k_rem = k·exp(cum_last - cum); the strictly lower
// C x C matrix A = r_dec·k_invᵀ (entries at or above the diagonal are never
// formed); y = r_dec·S + A·v + (r·u·k) v; then S ← exp(cum_last) S +
// k_remᵀ v.  Rows are padded to N + 1 floats so a column walk hits 32
// different banks.  Batch, sequence and head strides come from the caller,
// so the model's (B, S, H, N) and the op's (B, H, S, N) both read in place.
// The products run on the FMA units; tensor cores are later work.

#include "kernel_common.cuh"

namespace {

using kernel_common::to_f32;

constexpr int THREADS = 256;
constexpr int MAX_N = 64;
constexpr int MAX_C = 64;
constexpr float LOG_CLAMP = 80.0f;

// Element strides (batch, sequence, head) of r, k, v, w and y; N is unit stride.
struct Strides {
    int64_t r[3], k[3], v[3], w[3], y[3];
};

size_t smem_floats(int C, int N) {
    const size_t LD = N + 1;
    return 5 * (size_t)C * LD      // r / r_dec, k / k_inv, v, log w / k_rem, cum
         + (size_t)C * (C + 1)     // A
         + (size_t)N * LD          // state
         + C + 2 * (size_t)N;      // diag, u, exp(cum_last)
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ sT,
               int H, int S, int N, int C, Strides st) {
    extern __shared__ __align__(16) float sm[];
    const int LD = N + 1;
    float* R = sm;                  // [C][LD] r, then r_dec
    float* K = R + C * LD;          // [C][LD] k, then k_inv
    float* V = K + C * LD;          // [C][LD] v
    float* LW = V + C * LD;         // [C][LD] clamped log w, then k_rem
    float* CU = LW + C * LD;        // [C][LD] inclusive cumsum of log w
    float* A = CU + C * LD;         // [C][C + 1]
    float* Sm = A + C * (C + 1);    // [N][LD] state
    float* DG = Sm + N * LD;        // [C] r·u·k
    float* U = DG + C;              // [N]
    float* ECL = U + N;             // [N] exp(cum_last)

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const float clamp = -LOG_CLAMP / (float)C;

    const T* rb = r + b * st.r[0] + h * st.r[2];
    const T* kb = k + b * st.k[0] + h * st.k[2];
    const T* vb = v + b * st.v[0] + h * st.v[2];
    const float* wb = w + b * st.w[0] + h * st.w[2];
    float* yb = y + b * st.y[0] + h * st.y[2];
    const int64_t state_off = ((int64_t)b * H + h) * N * N;

    for (int i = tid; i < N * N; i += THREADS) Sm[(i / N) * LD + i % N] = s0[state_off + i];
    for (int i = tid; i < N; i += THREADS) U[i] = u[h * N + i];

    for (int c0 = 0; c0 < S; c0 += C) {
        // 1. the chunk's inputs; steps past S are the reference's pad steps
        for (int i = tid; i < C * N; i += THREADS) {
            const int t = i / N, n = i % N;
            const int64_t pos = c0 + t;
            float rr = 0.f, kk = 0.f, vv = 0.f, lw = 0.f;
            if (pos < S) {
                rr = to_f32(rb[pos * st.r[1] + n]);
                kk = to_f32(kb[pos * st.k[1] + n]);
                vv = to_f32(vb[pos * st.v[1] + n]);
                lw = fmaxf(logf(fmaxf(wb[pos * st.w[1] + n], 1e-38f)), clamp);
            }
            R[t * LD + n] = rr;
            K[t * LD + n] = kk;
            V[t * LD + n] = vv;
            LW[t * LD + n] = lw;
        }
        __syncthreads();

        // 2. cumulative log-decay per channel (threads 0..N-1) and the
        //    u-diagonal per step (threads N..N+C-1)
        if (tid < N) {
            float acc = 0.f;
            for (int t = 0; t < C; ++t) {
                acc += LW[t * LD + tid];
                CU[t * LD + tid] = acc;
            }
        } else if (tid < N + C) {
            const int t = tid - N;
            float d = 0.f;
            for (int n = 0; n < N; ++n) d += R[t * LD + n] * U[n] * K[t * LD + n];
            DG[t] = d;
        }
        __syncthreads();

        // 3. decayed operands, each thread on its own elements
        for (int i = tid; i < C * N; i += THREADS) {
            const int t = i / N, n = i % N;
            const float cu = CU[t * LD + n];
            const float lw = LW[t * LD + n];
            const float kk = K[t * LD + n];
            const float cl = CU[(C - 1) * LD + n];
            R[t * LD + n] *= expf(cu - lw);   // r·exp(cum_prev), exponent <= 0
            K[t * LD + n] = kk * expf(-cu);   // bounded by the clamp
            LW[t * LD + n] = kk * expf(cl - cu);
        }
        for (int i = tid; i < N; i += THREADS) ECL[i] = expf(CU[(C - 1) * LD + i]);
        __syncthreads();

        // 4. A[t][j] = r_dec[t]·k_inv[j] for j < t
        for (int i = tid; i < C * C; i += THREADS) {
            const int t = i / C, j = i % C;
            float a = 0.f;
            if (j < t) {
                for (int n = 0; n < N; ++n) a += R[t * LD + n] * K[j * LD + n];
            }
            A[t * (C + 1) + j] = a;
        }
        __syncthreads();

        // 5. y = r_dec·S + A·v + diag·v
        for (int i = tid; i < C * N; i += THREADS) {
            const int t = i / N, m = i % N;
            const int64_t pos = c0 + t;
            if (pos >= S) continue;
            float inter = 0.f, intra = 0.f;
            for (int n = 0; n < N; ++n) inter += R[t * LD + n] * Sm[n * LD + m];
            for (int j = 0; j < t; ++j) intra += A[t * (C + 1) + j] * V[j * LD + m];
            yb[pos * st.y[1] + m] = inter + intra + DG[t] * V[t * LD + m];
        }
        __syncthreads();

        // 6. S ← exp(cum_last) S + k_remᵀ v
        for (int i = tid; i < N * N; i += THREADS) {
            const int n = i / N, m = i % N;
            float acc = 0.f;
            for (int t = 0; t < C; ++t) acc += LW[t * LD + n] * V[t * LD + m];
            Sm[n * LD + m] = ECL[n] * Sm[n * LD + m] + acc;
        }
        __syncthreads();
    }

    for (int i = tid; i < N * N; i += THREADS) sT[state_off + i] = Sm[(i / N) * LD + i % N];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* s0, float* y, float* sT, int B, int H, int S, int N, int C,
           const Strides& st, cudaStream_t stream) {
    auto kern = wkv_fwd_kernel<T>;
    // granted once per device, at the largest size any (C, N) needs
    static kernel_common::SmemGrant grant;
    cudaError_t e = grant.ensure(kern, smem_floats(MAX_C, MAX_N) * sizeof(float));
    if (e != cudaSuccess) return (int)e;
    dim3 grid(H, B);
    kern<<<grid, THREADS, smem_floats(C, N) * sizeof(float), stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
        w, u, s0, y, sT, H, S, N, C, st);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (of r, k, v): 0 float32, 1 bfloat16.  r, k, v, w, y are indexed
// [b][s][h][n] through strides = {r_b, r_s, r_h, k_b, k_s, k_h, v_b, v_s,
// v_h, w_b, w_s, w_h, y_b, y_s, y_h} (elements; n has unit stride); u is
// (H, N) and state_in / state_out (B, H, N, N), contiguous f32.  Needs
// 1 <= N <= 64, 1 <= chunk <= 64, S >= 1.  Returns the cudaError_t of the
// launch (0 on success).
int rwkv6_wkv_fwd(int dtype, const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* state_in, void* y, void* state_out,
                  int B, int H, int S, int N, int chunk, const int64_t* strides, void* stream) {
    if (N < 1 || N > MAX_N || chunk < 1 || chunk > MAX_C || S < 1 || B < 1 || H < 1)
        return (int)cudaErrorInvalidValue;
    Strides st;
    for (int i = 0; i < 3; ++i) {
        st.r[i] = strides[i];
        st.k[i] = strides[3 + i];
        st.v[i] = strides[6 + i];
        st.w[i] = strides[9 + i];
        st.y[i] = strides[12 + i];
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* wf = static_cast<const float*>(w);
    const float* uf = static_cast<const float*>(u);
    const float* s0 = static_cast<const float*>(state_in);
    float* yf = static_cast<float*>(y);
    float* sT = static_cast<float*>(state_out);
    switch (dtype) {
        case 0: return launch<float>(r, k, v, wf, uf, s0, yf, sT, B, H, S, N, chunk, st, s);
        case 1: return launch<__nv_bfloat16>(r, k, v, wf, uf, s0, yf, sT, B, H, S, N, chunk, st, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* rwkv6_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
