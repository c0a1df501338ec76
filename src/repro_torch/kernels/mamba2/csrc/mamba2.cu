// Mamba-2 SSD scan (forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/mamba2/mamba2.py::ssd_kernel (body ``_kernel``)
// and computes the same function as the model's scan
//   src/repro/models/ssm.py::mamba2_ssd_chunked:
//     S_t = a_t S_{t-1} + dt_t (x_t ⊗ B_t),   y_t = C_t · S_t
// chunk by chunk: with cum_t the inclusive sum of log a within the chunk,
//     y_t = Σ_{j<=t} (C_t·B_j) exp(cum_t - cum_j) dt_j x_j + exp(cum_t) C_t·Sᵀ
//     S  ← exp(cum_last) S + Σ_j exp(cum_last - cum_j) dt_j x_j ⊗ B_j
// x, B, C arrive as bf16 or f32, a/dt/state as f32; all arithmetic is f32;
// y goes out in f32 and the final state is written once.
//
// What bounds it on an H100: per chunk of C steps it does about
// C²·(N + P) + 4·C·P·N flops per (b, h) on C·(P + 2N + 2) inputs; at the
// model's shapes (C 256 over a 128-step prompt, P = N = 64) that is ~50
// flops per byte, under the f32 ridge, so memory and the serial chunk loop
// bound it.
//
// Design.  The TPU kernel walks a sequential grid axis over 64-step chunks
// and keeps the P x N state in VMEM scratch.  Here one thread block owns
// one (b, h), loops over the chunks itself and keeps the state in shared
// memory for the whole sequence.  The model's chunk is 256, and a 256 x 256
// f32 matrix (256 KB) does not fit in the 227 KB a block may use, so a
// chunk is walked in 64-step tiles: for each 64-row tile of queries, the
// 64 x 64 tiles of C_t·B_j on or below the diagonal are formed one at a
// time, weighted and applied to x, and the tiles above the diagonal are
// never formed (no exp of a masked entry, so nothing to overflow).  The
// log-differences cum_t - cum_j are formed before the exp, so every kept
// exponent is <= 0.  Steps past S are the reference's pad steps (a = 1,
// dt = 0: no-ops) and are skipped, so the wrapper pads nothing.  The
// cumulative sum is one thread's loop, in the plain version's order.  B
// and C are shared across
// heads, so each of the H blocks of a sequence reads them again (from L2).
// Batch, sequence and head strides come from the caller: the model's views
// into its convolution output are read in place.  The products run on the
// FMA units; tensor cores are later work.

#include "kernel_common.cuh"

namespace {

using kernel_common::to_f32;

constexpr int THREADS = 256;
constexpr int TT = 64;                                 // steps per tile of a chunk
constexpr int MAX_PN = 64;                             // largest P and N
constexpr int MAX_CHUNK = 256;
constexpr int W_PER = TT * TT / THREADS;               // W entries per thread
constexpr int OUT_PER = TT * MAX_PN / THREADS;         // y entries per thread
constexpr int ST_PER = MAX_PN * MAX_PN / THREADS;      // state entries per thread

// Element strides: x, a, dt, y (batch, sequence, head); B, C (batch,
// sequence).  The last dim of x, B, C and y has unit stride.
struct Strides {
    int64_t x[3], b[2], c[2], a[3], dt[3], y[3];
};

size_t smem_floats(int P, int N) {
    return 2 * (size_t)TT * (N + 1)   // C rows, B rows
         + (size_t)TT * (P + 1)       // x rows
         + (size_t)TT * (TT + 1)      // W tile
         + (size_t)P * (N + 1)        // state
         + 2 * (size_t)MAX_CHUNK      // cum, dt
         + TT;                        // decay_rem
}

// TT rows of ``width`` elements into shared memory (row stride ld); rows at
// or past ``rows`` read as zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, int64_t stride,
                                          int rows, int width, int tid) {
    for (int i = tid; i < TT * width; i += THREADS) {
        const int r = i / width, c = i % width;
        dst[r * ld + c] = r < rows ? to_f32(src[r * stride + c]) : 0.f;
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_fwd_kernel(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
               const float* __restrict__ a, const float* __restrict__ dt,
               const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ sT,
               int S, int H, int P, int N, int C, Strides st) {
    extern __shared__ __align__(16) float sm[];
    const int LN = N + 1, LP = P + 1, LW = TT + 1;
    float* Cs = sm;                   // [TT][LN]
    float* Bs = Cs + TT * LN;         // [TT][LN]
    float* Xs = Bs + TT * LN;         // [TT][LP]
    float* W = Xs + TT * LP;          // [TT][LW]
    float* Sm = W + TT * LW;          // [P][LN]
    float* CUM = Sm + P * LN;         // [MAX_CHUNK]
    float* DT = CUM + MAX_CHUNK;      // [MAX_CHUNK]
    float* DR = DT + MAX_CHUNK;       // [TT]

    const int h = blockIdx.x;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;

    const T* xb = x + b * st.x[0] + h * st.x[2];
    const T* bb = Bm + b * st.b[0];
    const T* cb = Cm + b * st.c[0];
    const float* ab = a + b * st.a[0] + h * st.a[2];
    const float* db = dt + b * st.dt[0] + h * st.dt[2];
    float* yb = y + b * st.y[0] + h * st.y[2];
    const int64_t state_off = ((int64_t)b * H + h) * P * N;

    for (int i = tid; i < P * N; i += THREADS) Sm[(i / N) * LN + i % N] = s0[state_off + i];

    for (int c0 = 0; c0 < S; c0 += C) {
        const int L = min(C, S - c0);  // steps of this chunk; the rest would be pad steps
        // 1. log a and dt, then the inclusive cumulative sum, one f32 add per
        //    step in sequence order (the plain version's order: the cum of
        //    a long chunk reaches -100s, and a sum taken in another order
        //    moves exp(cum_t - cum_j) by ~1e-5 of itself)
        for (int i = tid; i < L; i += THREADS) {
            CUM[i] = logf(fmaxf(ab[(int64_t)(c0 + i) * st.a[1]], 1e-38f));
            DT[i] = db[(int64_t)(c0 + i) * st.dt[1]];
        }
        __syncthreads();
        if (tid == 0) {
            float run = 0.f;
            for (int i = 0; i < L; ++i) {
                run += CUM[i];
                CUM[i] = run;
            }
        }
        __syncthreads();
        const float cum_last = CUM[L - 1];

        // 2. y, one 64-row tile of the chunk at a time
        for (int r0 = 0; r0 < L; r0 += TT) {
            const int rows = min(TT, L - r0);
            load_rows(Cs, LN, cb + (int64_t)(c0 + r0) * st.c[1], st.c[1], rows, N, tid);
            float acc[OUT_PER];
#pragma unroll
            for (int o = 0; o < OUT_PER; ++o) acc[o] = 0.f;
            for (int j0 = 0; j0 <= r0; j0 += TT) {
                const int cols = min(TT, L - j0);
                __syncthreads();  // the last tile's readers are done with Bs, Xs, W
                load_rows(Bs, LN, bb + (int64_t)(c0 + j0) * st.b[1], st.b[1], cols, N, tid);
                load_rows(Xs, LP, xb + (int64_t)(c0 + j0) * st.x[1], st.x[1], cols, P, tid);
                __syncthreads();
                // W[t][j] = (C_t·B_j) exp(cum_t - cum_j) dt_j, formed only for j <= t
#pragma unroll 4
                for (int o = 0; o < W_PER; ++o) {
                    const int i = tid + o * THREADS;
                    const int t = i / TT, j = i % TT;
                    const int tg = r0 + t, jg = j0 + j;
                    float wv = 0.f;
                    if (t < rows && j < cols && jg <= tg) {
                        float g = 0.f;
                        for (int n = 0; n < N; ++n) g += Cs[t * LN + n] * Bs[j * LN + n];
                        wv = g * expf(CUM[tg] - CUM[jg]) * DT[jg];
                    }
                    W[t * LW + j] = wv;
                }
                __syncthreads();
#pragma unroll
                for (int o = 0; o < OUT_PER; ++o) {
                    const int i = tid + o * THREADS;
                    if (i < TT * P) {
                        const int t = i / P, p = i % P;
                        float s = 0.f;
                        for (int j = 0; j < cols; ++j) s += W[t * LW + j] * Xs[j * LP + p];
                        acc[o] += s;
                    }
                }
            }
            // y_intra + exp(cum_t) C_t·Sᵀ (the state at the chunk's start)
#pragma unroll
            for (int o = 0; o < OUT_PER; ++o) {
                const int i = tid + o * THREADS;
                if (i < TT * P) {
                    const int t = i / P, p = i % P;
                    if (t < rows) {
                        float s = 0.f;
                        for (int n = 0; n < N; ++n) s += Cs[t * LN + n] * Sm[p * LN + n];
                        yb[(int64_t)(c0 + r0 + t) * st.y[1] + p] = acc[o] + expf(CUM[r0 + t]) * s;
                    }
                }
            }
            __syncthreads();  // Cs, Bs, Xs, W are free for the next tile
        }

        // 3. S ← exp(cum_last) S + Σ_j (exp(cum_last - cum_j) dt_j x_j) ⊗ B_j
        float acc[ST_PER];
#pragma unroll
        for (int o = 0; o < ST_PER; ++o) acc[o] = 0.f;
        for (int j0 = 0; j0 < L; j0 += TT) {
            const int cols = min(TT, L - j0);
            load_rows(Bs, LN, bb + (int64_t)(c0 + j0) * st.b[1], st.b[1], cols, N, tid);
            load_rows(Xs, LP, xb + (int64_t)(c0 + j0) * st.x[1], st.x[1], cols, P, tid);
            if (tid < TT) DR[tid] = tid < cols ? expf(cum_last - CUM[j0 + tid]) * DT[j0 + tid] : 0.f;
            __syncthreads();
#pragma unroll
            for (int o = 0; o < ST_PER; ++o) {
                const int i = tid + o * THREADS;
                if (i < P * N) {
                    const int p = i / N, n = i % N;
                    float s = 0.f;
                    for (int j = 0; j < cols; ++j) s += DR[j] * Xs[j * LP + p] * Bs[j * LN + n];
                    acc[o] += s;
                }
            }
            __syncthreads();  // before the next tile overwrites Bs, Xs, DR
        }
        const float decay = expf(cum_last);
#pragma unroll
        for (int o = 0; o < ST_PER; ++o) {
            const int i = tid + o * THREADS;
            if (i < P * N) {
                const int p = i / N, n = i % N;
                Sm[p * LN + n] = decay * Sm[p * LN + n] + acc[o];
            }
        }
        __syncthreads();
    }

    for (int i = tid; i < P * N; i += THREADS) sT[state_off + i] = Sm[(i / N) * LN + i % N];
}

template <typename T>
int launch(const void* x, const void* Bm, const void* Cm, const float* a, const float* dt,
           const float* s0, float* y, float* sT, int B, int S, int H, int P, int N, int C,
           const Strides& st, cudaStream_t stream) {
    auto kern = ssd_fwd_kernel<T>;
    // granted once per device, at the largest size any (P, N) needs
    static kernel_common::SmemGrant grant;
    cudaError_t e = grant.ensure(kern, smem_floats(MAX_PN, MAX_PN) * sizeof(float));
    if (e != cudaSuccess) return (int)e;
    dim3 grid(H, B);
    kern<<<grid, THREADS, smem_floats(P, N) * sizeof(float), stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(Bm), static_cast<const T*>(Cm),
        a, dt, s0, y, sT, S, H, P, N, C, st);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (of x, Bm, Cm): 0 float32, 1 bfloat16.  x and y are indexed
// [b][s][h][p], Bm and Cm [b][s][n], a and dt [b][s][h], through strides =
// {x_b, x_s, x_h, B_b, B_s, C_b, C_s, a_b, a_s, a_h, dt_b, dt_s, dt_h, y_b,
// y_s, y_h} (elements; the last dim of x, Bm, Cm, y has unit stride);
// state_in / state_out are (B, H, P, N), contiguous f32.  Needs
// 1 <= P, N <= 64, 1 <= chunk <= 256, S >= 1.  Returns the cudaError_t of
// the launch (0 on success).
int mamba2_ssd_fwd(int dtype, const void* x, const void* Bm, const void* Cm, const void* a,
                   const void* dt, const void* state_in, void* y, void* state_out,
                   int B, int S, int H, int P, int N, int chunk, const int64_t* strides,
                   void* stream) {
    if (P < 1 || P > MAX_PN || N < 1 || N > MAX_PN || chunk < 1 || chunk > MAX_CHUNK ||
        S < 1 || B < 1 || H < 1)
        return (int)cudaErrorInvalidValue;
    Strides st;
    for (int i = 0; i < 3; ++i) {
        st.x[i] = strides[i];
        st.a[i] = strides[7 + i];
        st.dt[i] = strides[10 + i];
        st.y[i] = strides[13 + i];
    }
    for (int i = 0; i < 2; ++i) {
        st.b[i] = strides[3 + i];
        st.c[i] = strides[5 + i];
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* af = static_cast<const float*>(a);
    const float* df = static_cast<const float*>(dt);
    const float* s0 = static_cast<const float*>(state_in);
    float* yf = static_cast<float*>(y);
    float* sT = static_cast<float*>(state_out);
    switch (dtype) {
        case 0: return launch<float>(x, Bm, Cm, af, df, s0, yf, sT, B, S, H, P, N, chunk, st, s);
        case 1: return launch<__nv_bfloat16>(x, Bm, Cm, af, df, s0, yf, sT, B, S, H, P, N, chunk, st, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* mamba2_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
