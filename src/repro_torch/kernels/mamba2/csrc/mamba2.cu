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
// x, B, C arrive as bf16 or f32, a/dt/state as f32; y goes out in f32 and
// the final state is written once.
//
// What bounds it on an H100: per chunk of C steps it does about
// C²·(N + P) + 4·C·P·N flops per (b, h) on C·(P + 2N + 2) inputs; at the
// model's shapes (C 256 over a 128-step prompt, P = N = 64) that is ~50
// flops per byte, under the ridge, so the bytes bound it (1.6 µs at B 1,
// S 128, H 64).  What held the first version back was the shape of the
// work, not the bytes: one block per (b, h) walked the chunks in series
// (64 blocks on 132 SMs) and formed every product on the FMA units with
// two shared-memory loads per FMA.
//
// Design: the chunks in parallel, three kernels behind one entry point.
//  (a) ssd_local_kernel, one block per (b, chunk, h): the chunk's
//      cumulative log-decay (one thread, in sequence order, as the plain
//      version takes it: a 256-step cum reaches -100s and another order
//      moves exp(cum_t - cum_j) by ~1e-5 of itself), written to a
//      workspace, and the chunk's local state Σ_j (exp(cum_last - cum_j)
//      dt_j x_j) ⊗ B_j from a zero start, a warp per 16 state rows and
//      half of each 64-step tile, the halves joined at the end.
//  (b) ssd_pass_kernel, one thread per state entry: the only sequential
//      part, S ← exp(cum_last) S + local over the chunks, elementwise; it
//      leaves each chunk's starting state in the workspace (in place of
//      its local state) and writes the final state.  With one chunk (a)
//      writes the final state itself and (b) is not launched.
//  (c) ssd_out_kernel, one block per (b, chunk, 64-row tile, h), a warp
//      per 16 rows and half the columns of P: y for the tile's rows from the chunk's starting state (chunk 0 reads the
//      caller's state) and the 64 x 64 tiles of C·Bᵀ on or below the
//      diagonal; tiles above it are never formed, and the log-differences
//      cum_t - cum_j are formed before the exp, so every kept exponent is
//      <= 0.
// Steps past S are the reference's pad steps (a = 1, dt = 0: no-ops) and
// are skipped, so the wrapper pads nothing.  Batch, sequence and head
// strides come from the caller: the model's views into its convolution
// output are read in place.
//
// The products run on the tensor cores, mma.sync m16n8k16, eight warps a
// block: C·Bᵀ, C·Sᵀ, W·x and the local state's
// (dt·decay·x)ᵀ·B, with W kept in registers between C·Bᵀ and W·x.  Every
// f32 operand (W, the scaled x, the state; and x, B, C themselves in the
// f32 instance) is split into three bf16 pieces and the products of the
// pieces summed in f32 (include/mma_split.cuh): a single bf16 rounding
// misses the 4e-4 tolerance 50-270 times over and two pieces use up to
// 0.9 of it (mamba2/ref.py::ssd_tiles_plain and its tests).  bf16 x, B
// and C go in exactly, as one piece.

#include <cstdio>
#include <initializer_list>
#include <type_traits>

#include "kernel_common.cuh"
#include "mma_split.cuh"

namespace {

using kernel_common::to_f32;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TT = 64;            // steps per row or column tile of a chunk
constexpr int MAX_PN = 64;        // largest P and N
constexpr int MAX_CHUNK = 256;
constexpr int LD = TT + 8;        // row stride (floats) of 64-wide tiles read k-contiguous
constexpr int LDT = TT + 4;       // ... and of those read across rows (mma_split.cuh)
constexpr int NT = MAX_PN / 8;    // 8-column tiles of a 64-wide product
constexpr int OUT_SMEM = (3 * TT * LD + TT * LDT + 2 * MAX_CHUNK) * (int)sizeof(float);

// bf16 pieces of an input operand: exact in bf16, split in f32
template <typename T> constexpr int kPieces = std::is_same_v<T, __nv_bfloat16> ? 1 : 3;

// Element strides: x, a, dt, y (batch, sequence, head); B, C (batch,
// sequence).  The last dim of x, B, C and y has unit stride.
struct Strides {
    int64_t x[3], b[2], c[2], a[3], dt[3], y[3];
};

struct Dims {
    int S, H, P, N, C, nc;
    bool vx, vbc, vs;  // x, B and C, the state: rows 16-byte aligned (vector loads)
};

__device__ __forceinline__ int64_t chunk_row(const Dims& d, int b, int c, int h) {
    return ((int64_t)b * d.nc + c) * d.H + h;
}

// ``rows`` x ``width`` elements of a row-major source (row stride
// ``stride`` elements) into a 64 x 64 f32 tile at ``dst`` (row stride
// ``ld``), row r scaled by scale[r] when ``scale`` is given; zeros
// elsewhere.  ``vec``: 16-byte loads, every one of a thread's issued before
// the first is stored (the rows and ``width`` 16-byte aligned).
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int64_t stride, int rows, int width,
                                          bool vec, const float* scale, int tid) {
    if (vec) {
        constexpr int PER = 16 / sizeof(T), CPR = TT / PER, ITERS = TT * CPR / THREADS;
        uint4 buf[ITERS];
#pragma unroll
        for (int it = 0; it < ITERS; ++it) {
            const int i = tid + it * THREADS, r = i / CPR, c = (i % CPR) * PER;
            buf[it] = r < rows && c < width ? __ldg(reinterpret_cast<const uint4*>(src + r * stride + c))
                                            : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int it = 0; it < ITERS; ++it) {
            const int i = tid + it * THREADS, r = i / CPR, c = (i % CPR) * PER;
            const T* e = reinterpret_cast<const T*>(&buf[it]);
            const float sc = scale != nullptr && r < rows ? scale[r] : 1.f;
#pragma unroll
            for (int q = 0; q < PER; q += 4)
                *reinterpret_cast<float4*>(dst + r * ld + c + q) =
                    make_float4(sc * to_f32(e[q]), sc * to_f32(e[q + 1]), sc * to_f32(e[q + 2]), sc * to_f32(e[q + 3]));
        }
    } else {
        for (int i = tid; i < TT * TT; i += THREADS) {
            const int r = i / TT, c = i % TT;
            const bool in = r < rows && c < width;
            dst[r * ld + c] = in ? (scale != nullptr ? scale[r] : 1.f) * to_f32(src[r * stride + c]) : 0.f;
        }
    }
}

// ------------------------------------------------------------------ (a)
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_local_kernel(const T* __restrict__ x, const T* __restrict__ Bm, const float* __restrict__ a,
                 const float* __restrict__ dt, const float* __restrict__ s0, float* __restrict__ cum_ws,
                 float* __restrict__ state_ws, float* __restrict__ sT, Dims d, Strides st) {
    __shared__ float CUM[MAX_CHUNK], DR[MAX_CHUNK];
    __shared__ __align__(16) float Xs[TT * LDT];  // [j][p]: decay_j dt_j x_j[p]
    __shared__ __align__(16) float Bs[TT * LDT];  // [j][n]: B_j[n]
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int c0 = c * d.C, L = min(d.C, d.S - c0);
    const float* ab = a + b * st.a[0] + h * st.a[2] + (int64_t)c0 * st.a[1];
    const float* db = dt + b * st.dt[0] + h * st.dt[2] + (int64_t)c0 * st.dt[1];
    const T* xb = x + b * st.x[0] + h * st.x[2] + (int64_t)c0 * st.x[1];
    const T* bb = Bm + b * st.b[0] + (int64_t)c0 * st.b[1];

    for (int i = tid; i < L; i += THREADS) {
        CUM[i] = logf(fmaxf(ab[i * st.a[1]], 1e-38f));
        DR[i] = db[i * st.dt[1]];
    }
    __syncthreads();
    if (tid == 0) {  // one f32 add per step, in sequence order
        float run = 0.f;
#pragma unroll 8
        for (int i = 0; i < L; ++i) {
            run += CUM[i];
            CUM[i] = run;
        }
    }
    __syncthreads();
    const float cum_last = CUM[L - 1];
    float* cw = cum_ws + chunk_row(d, b, c, h) * d.C;
    for (int i = tid; i < L; i += THREADS) {
        cw[i] = CUM[i];
        DR[i] = expf(cum_last - CUM[i]) * DR[i];
    }

    // warp w: state rows p0 .. p0 + 15, the k-steps kh·32 .. + 31 of each tile
    float acc[NT][4] = {};
    const int p0 = 16 * (warp & 3), kh = warp >> 2;
    for (int j0 = 0; j0 < L; j0 += TT) {
        const int cols = min(TT, L - j0);
        __syncthreads();  // DR is written; the last tile's readers are done
        load_tile(Xs, LDT, xb + (int64_t)j0 * st.x[1], st.x[1], cols, d.P, d.vx, DR + j0, tid);
        load_tile(Bs, LDT, bb + (int64_t)j0 * st.b[1], st.b[1], cols, d.N, d.vbc, (const float*)nullptr, tid);
        __syncthreads();
        if (p0 < d.P) {
#pragma unroll
            for (int kk = 0; kk < TT / 32; ++kk) {
                const int ks = 2 * kh + kk;
                if (16 * ks >= cols) break;
                uint32_t xa[3][4];
                mma_split::load_a_t<3>(xa, Xs + 16 * ks * LDT + p0, LDT, lane);
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    if (8 * nt < d.N) {
                        uint32_t bf[kPieces<T>][2];
                        mma_split::load_b_t<kPieces<T>>(bf, Bs + 16 * ks * LDT + 8 * nt, LDT, lane);
                        mma_split::mma(acc[nt], xa, bf);
                    }
                }
            }
        }
    }

    // the two halves' sums joined through shared memory, then the local
    // state, [p][n]; with one chunk, the final state exp(cum_last) S0 +
    // local in its place (the pass has nothing else to do)
    const bool one = d.nc == 1;
    const int64_t so = ((int64_t)b * d.H + h) * d.P * d.N;
    float* sw = one ? sT + so : state_ws + chunk_row(d, b, c, h) * d.P * d.N;
    const float decay = expf(cum_last);
    const int g = lane >> 2, cq = lane & 3;
    float* part = Xs;  // [p][n]
    __syncthreads();   // every warp is done with Xs
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int p = p0 + g + (e >= 2 ? 8 : 0), n = 8 * nt + 2 * cq + (e & 1);
            if (kh == 1) part[p * LDT + n] = acc[nt][e];
        }
    __syncthreads();
    if (kh == 0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int p = p0 + g + (e >= 2 ? 8 : 0), n = 8 * nt + 2 * cq + (e & 1);
                if (p < d.P && n < d.N) {
                    const float local = acc[nt][e] + part[p * LDT + n];
                    sw[p * d.N + n] = one ? decay * s0[so + p * d.N + n] + local : local;
                }
            }
    }
}

// ------------------------------------------------------------------ (b)
__global__ void __launch_bounds__(256)
ssd_pass_kernel(const float* __restrict__ s0, float* __restrict__ state_ws, const float* __restrict__ cum_ws,
                float* __restrict__ sT, Dims d) {
    const int h = blockIdx.y, b = blockIdx.z;
    const int e = blockIdx.x * 256 + threadIdx.x;
    const int PN = d.P * d.N;
    if (e >= PN) return;
    const int64_t so = ((int64_t)b * d.H + h) * PN + e;
    float s = s0[so];
    constexpr int BATCH = 8;  // chunks whose loads go out before their stores
    for (int c0 = 0; c0 < d.nc; c0 += BATCH) {
        float cl[BATCH], local[BATCH];
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
            const int c = c0 + i;
            if (c < d.nc) {
                cl[i] = cum_ws[chunk_row(d, b, c, h) * d.C + min(d.C, d.S - c * d.C) - 1];
                local[i] = state_ws[chunk_row(d, b, c, h) * PN + e];
            }
        }
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
            const int c = c0 + i;
            if (c < d.nc) {
                if (c > 0) state_ws[chunk_row(d, b, c, h) * PN + e] = s;  // the state at chunk c's start
                s = expf(cl[i]) * s + local[i];
            }
        }
    }
    sT[so] = s;
}

// ------------------------------------------------------------------ (c)
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_out_kernel(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
               const float* __restrict__ dt, const float* __restrict__ s0, const float* __restrict__ cum_ws,
               const float* __restrict__ state_ws, float* __restrict__ y, Dims d, Strides st) {
    extern __shared__ __align__(16) float sm[];
    float* Cs = sm;               // [t][n]: C rows of this tile
    float* Ss = Cs + TT * LD;     // [p][n]: the chunk's starting state
    float* Bs = Ss + TT * LD;     // [j][n]: B rows of a column tile
    float* Xs = Bs + TT * LD;     // [j][p]: x of a column tile
    float* CUM = Xs + TT * LDT;   // [MAX_CHUNK]
    float* DT = CUM + MAX_CHUNK;  // [MAX_CHUNK]

    const int tiles = (d.C + TT - 1) / TT;
    const int c = blockIdx.x / tiles;
    const int r0 = TT * (tiles - 1 - blockIdx.x % tiles);  // the heaviest tiles first
    const int h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int c0 = c * d.C, L = min(d.C, d.S - c0);
    if (r0 >= L) return;
    const int rows = min(TT, L - r0);

    const float* db = dt + b * st.dt[0] + h * st.dt[2] + (int64_t)c0 * st.dt[1];
    const T* xb = x + b * st.x[0] + h * st.x[2] + (int64_t)c0 * st.x[1];
    const T* bb = Bm + b * st.b[0] + (int64_t)c0 * st.b[1];
    const T* cb = Cm + b * st.c[0] + (int64_t)(c0 + r0) * st.c[1];
    const float* cw = cum_ws + chunk_row(d, b, c, h) * d.C;
    const float* sb = c == 0 ? s0 + ((int64_t)b * d.H + h) * d.P * d.N
                             : state_ws + chunk_row(d, b, c, h) * d.P * d.N;

    for (int i = tid; i < r0 + rows; i += THREADS) {
        CUM[i] = cw[i];
        DT[i] = db[i * st.dt[1]];
    }
    load_tile(Cs, LD, cb, st.c[1], rows, d.N, d.vbc, (const float*)nullptr, tid);
    load_tile(Ss, LD, sb, d.N, d.P, d.N, d.vs, (const float*)nullptr, tid);
    __syncthreads();

    constexpr int KP = kPieces<T>;
    // warp w: rows t0 .. t0 + 15 of the tile, columns p of its half of P
    // (8-column tiles ph·4 .. + 3); both halves form the same C·Bᵀ rows
    constexpr int PT = NT / 2;
    const int t0 = 16 * (warp & 3), ph = warp >> 2;
    const int g = lane >> 2, cq = lane & 3;
    const int tA = r0 + t0 + g, tB = tA + 8;   // its two rows in the chunk

    // exp(cum_t) C_t·S_startᵀ
    float acc[PT][4] = {};
#pragma unroll
    for (int ks = 0; ks < MAX_PN / 16; ++ks) {
        if (16 * ks >= d.N) break;
        uint32_t ca[KP][4];
        mma_split::load_a<KP>(ca, Cs + t0 * LD + 16 * ks, LD, lane);
#pragma unroll
        for (int nt = 0; nt < PT; ++nt) {
            const int pt = PT * ph + nt;
            if (8 * pt < d.P) {
                uint32_t sf[3][2];
                mma_split::load_b<3>(sf, Ss + 8 * pt * LD + 16 * ks, LD, lane);
                mma_split::mma(acc[nt], ca, sf);
            }
        }
    }
    const float eA = tA < L ? expf(CUM[tA]) : 0.f, eB = tB < L ? expf(CUM[tB]) : 0.f;
#pragma unroll
    for (int nt = 0; nt < PT; ++nt) {
        acc[nt][0] *= eA;
        acc[nt][1] *= eA;
        acc[nt][2] *= eB;
        acc[nt][3] *= eB;
    }

    // + W·x over the column tiles on or below the diagonal
    for (int j0 = 0; j0 <= r0; j0 += TT) {
        const int cols = min(TT, L - j0);
        __syncthreads();  // the last tile's readers are done with Bs, Xs
        load_tile(Bs, LD, bb + (int64_t)j0 * st.b[1], st.b[1], cols, d.N, d.vbc, (const float*)nullptr, tid);
        load_tile(Xs, LDT, xb + (int64_t)j0 * st.x[1], st.x[1], cols, d.P, d.vx, (const float*)nullptr, tid);
        __syncthreads();
        // G = C·Bᵀ (16 rows x 64 columns j)
        float w[NT][4] = {};
#pragma unroll
        for (int ks = 0; ks < MAX_PN / 16; ++ks) {
            if (16 * ks >= d.N) break;
            uint32_t ca[KP][4];
            mma_split::load_a<KP>(ca, Cs + t0 * LD + 16 * ks, LD, lane);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                if (8 * nt < cols) {
                    uint32_t bf[KP][2];
                    mma_split::load_b<KP>(bf, Bs + 8 * nt * LD + 16 * ks, LD, lane);
                    mma_split::mma(w[nt], ca, bf);
                }
            }
        }
        // W = G ∘ exp(cum_t - cum_j) ∘ dt_j for j <= t, else 0
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int t = e < 2 ? tA : tB, j = j0 + 8 * nt + 2 * cq + (e & 1);
                w[nt][e] = (j <= t && t < L) ? w[nt][e] * expf(CUM[t] - CUM[j]) * DT[j] : 0.f;
            }
        }
        // acc += W·x
#pragma unroll
        for (int kt = 0; kt < TT / 16; ++kt) {
            if (16 * kt >= cols) break;
            uint32_t wa[3][4];
            mma_split::acc_to_a<3>(wa, w[2 * kt], w[2 * kt + 1]);
#pragma unroll
            for (int nt = 0; nt < PT; ++nt) {
                const int pt = PT * ph + nt;
                if (8 * pt < d.P) {
                    uint32_t xf[KP][2];
                    mma_split::load_b_t<KP>(xf, Xs + 16 * kt * LDT + 8 * pt, LDT, lane);
                    mma_split::mma(acc[nt], wa, xf);
                }
            }
        }
    }

    float* yb = y + b * st.y[0] + h * st.y[2] + (int64_t)c0 * st.y[1];
#pragma unroll
    for (int nt = 0; nt < PT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int t = e < 2 ? tA : tB, p = 8 * (PT * ph + nt) + 2 * cq + (e & 1);
            if (t < L && p < d.P) yb[(int64_t)t * st.y[1] + p] = acc[nt][e];
        }
    }
}

// ------------------------------------------------------------- launches
int chunks(int S, int C) { return (S + C - 1) / C; }

struct Grids {
    dim3 local, pass, out;
};

Grids grids(int B, int S, int H, int P, int N, int C) {
    const int nc = chunks(S, C);
    return {dim3(nc, H, B), dim3((P * N + 255) / 256, H, B), dim3(nc * ((C + TT - 1) / TT), H, B)};
}

// the chunks' states in the workspace: none with one chunk, where (a)
// writes the final state itself
size_t state_floats(int B, int S, int H, int P, int N, int C) {
    return chunks(S, C) > 1 ? (size_t)B * chunks(S, C) * H * P * N : 0;
}

template <typename T>
int launch(const void* x, const void* Bm, const void* Cm, const float* a, const float* dt, const float* s0,
           float* y, float* sT, float* ws, int B, int S, int H, int P, int N, int C, const Strides& st,
           cudaStream_t stream) {
    auto aligned = [](const void* p, std::initializer_list<int64_t> strides, int width) {
        bool ok = reinterpret_cast<uintptr_t>(p) % 16 == 0 && (width * sizeof(T)) % 16 == 0;
        for (int64_t s : strides) ok = ok && (s * sizeof(T)) % 16 == 0;
        return ok;
    };
    const Dims d{S, H, P, N, C, chunks(S, C), aligned(x, {st.x[0], st.x[1], st.x[2]}, P),
                 aligned(Bm, {st.b[0], st.b[1]}, N) && aligned(Cm, {st.c[0], st.c[1]}, N),
                 reinterpret_cast<uintptr_t>(s0) % 16 == 0 && N % 4 == 0};
    const Grids gr = grids(B, S, H, P, N, C);
    float* state_ws = ws;
    float* cum_ws = ws + state_floats(B, S, H, P, N, C);
    const T* xt = static_cast<const T*>(x);
    const T* bt = static_cast<const T*>(Bm);
    ssd_local_kernel<T><<<gr.local, THREADS, 0, stream>>>(xt, bt, a, dt, s0, cum_ws, state_ws, sT, d, st);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (d.nc > 1) {
        ssd_pass_kernel<<<gr.pass, 256, 0, stream>>>(s0, state_ws, cum_ws, sT, d);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    auto out = ssd_out_kernel<T>;
    static kernel_common::SmemGrant grant;
    e = grant.ensure(out, OUT_SMEM);
    if (e != cudaSuccess) return (int)e;
    out<<<gr.out, THREADS, OUT_SMEM, stream>>>(xt, bt, static_cast<const T*>(Cm), dt, s0, cum_ws, state_ws, y,
                                               d, st);
    return (int)cudaGetLastError();
}

bool valid(int B, int S, int H, int P, int N, int chunk) {
    return P >= 1 && P <= MAX_PN && N >= 1 && N <= MAX_PN && chunk >= 1 && chunk <= MAX_CHUNK && S >= 1 &&
           B >= 1 && H >= 1;
}

}  // namespace

extern "C" {

// f32 workspace the entry point needs: each chunk's local, then starting,
// state (B, n_chunks, H, P, N; none for one chunk), then the per-chunk
// cumulative log-decay (B, n_chunks, H, chunk).  The caller allocates it.
size_t mamba2_ssd_workspace_floats(int B, int S, int H, int P, int N, int chunk) {
    if (!valid(B, S, H, P, N, chunk)) return 0;
    return state_floats(B, S, H, P, N, chunk) + (size_t)B * chunks(S, chunk) * H * chunk;
}

// dtype (of x, Bm, Cm): 0 float32, 1 bfloat16.  x and y are indexed
// [b][s][h][p], Bm and Cm [b][s][n], a and dt [b][s][h], through strides =
// {x_b, x_s, x_h, B_b, B_s, C_b, C_s, a_b, a_s, a_h, dt_b, dt_s, dt_h, y_b,
// y_s, y_h} (elements; the last dim of x, Bm, Cm, y has unit stride);
// state_in / state_out are (B, H, P, N), contiguous f32; workspace holds
// mamba2_ssd_workspace_floats(...) floats.  Needs 1 <= P, N <= 64,
// 1 <= chunk <= 256, S >= 1.  Three kernels, one call.  Returns the
// cudaError_t of the launches (0 on success).
int mamba2_ssd_fwd(int dtype, const void* x, const void* Bm, const void* Cm, const void* a,
                   const void* dt, const void* state_in, void* y, void* state_out, void* workspace,
                   int B, int S, int H, int P, int N, int chunk, const int64_t* strides,
                   void* stream) {
    if (!valid(B, S, H, P, N, chunk)) return (int)cudaErrorInvalidValue;
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
    float* ws = static_cast<float*>(workspace);
    switch (dtype) {
        case 0: return launch<float>(x, Bm, Cm, af, df, s0, yf, sT, ws, B, S, H, P, N, chunk, st, s);
        case 1: return launch<__nv_bfloat16>(x, Bm, Cm, af, df, s0, yf, sT, ws, B, S, H, P, N, chunk, st, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// What the entry point runs for a dtype and shape, as chip_smoke.py prints
// it: the product instruction and the bf16 pieces of each input operand,
// the granularity of the state pass, and the blocks of each kernel.
const char* mamba2_ssd_plan(int dtype, int B, int S, int H, int P, int N, int chunk) {
    static thread_local char buf[192];
    if (!valid(B, S, H, P, N, chunk) || (dtype != 0 && dtype != 1)) return "invalid";
    const Grids g = grids(B, S, H, P, N, chunk);
    const int pieces = dtype == 1 ? kPieces<__nv_bfloat16> : kPieces<float>;
    snprintf(buf, sizeof buf, "mma.sync_m16n8k16(xBC_pieces=%d,f32_pieces=3) state_pass_steps=%d blocks=%d+%d+%d",
             pieces, chunk, g.local.x * g.local.y * g.local.z,
             chunks(S, chunk) > 1 ? g.pass.x * g.pass.y * g.pass.z : 0, g.out.x * g.out.y * g.out.z);
    return buf;
}

const char* mamba2_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
