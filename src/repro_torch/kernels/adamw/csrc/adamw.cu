// Fused AdamW for Hopper, sm_90a: one optimizer step of one parameter
// leaf, as the reference computes it.
//
// Replaces no Pallas kernel.  The reference's optimizer
// (src/repro/training/optim.py::apply_updates: the global-norm clip at
// :101-106 and _update_leaf at :109-130) is plain jnp inside the jitted
// train step, which XLA fuses into one pass a leaf.  The port's eager
// version ran about 25 elementwise kernels a leaf; these kernels are that
// fusion, written out:
//   sq_norm          the leaf's sum of squares, for the global norm
//   factored_stats   the factored second moment's row and column means of
//                    g^2, folded into vr and vc (Adafactor-style v)
//   adamw_update     p, m and v (or p and m, reading vr and vc) in place
// Each takes the clip scale, lr and the two bias corrections from a device
// array that the step computes on the card (scal: scale, lr, 1 - b1^t,
// 1 - b2^t), so nothing reads the host and a step captures as a CUDA graph.
//
// Arithmetic.  Element by element the kernels do the plain version's f32
// operations (kernels/adamw/ref.py), each rounded as it rounds: the
// intrinsics __fmul_rn, __fadd_rn, __fdiv_rn and __fsqrt_rn are never
// contracted into an FMA.  g is clipped as f32(g) * scale rounded back to
// g's dtype (:106), then widened.  Sums (the norm and the factored means)
// are taken in f64, in an order fixed by the launch shape alone, and
// rounded once to f32: the result is the same bits on every run, so a
// replayed graph equals the eager step, and it is the correctly rounded
// f32 sum to within f64's error, which the plain version's f64 sum also
// gives, so the card's clip scale equals the CPU's.
//
// What bounds it on an H100: bytes.  adamw_update reads p and g (2 B each
// in bf16) and m and v (4 B each in f32) once and writes p, m and v: 22 B
// an element with f32 moments, 18 with a bf16 m, 10 with a bf16 m and a
// factored v; qwen3-14b at 8 layers (4.20 B parameters) moves 92.4 GB,
// 27.6 ms at 3.35 TB/s.  sq_norm and factored_stats read g once (2 B an
// element).  Each does some 20 f32 operations an element or fewer, far
// under the 67 TFLOP/s f32 rate.
//
// Design.  Every kernel walks the leaf as a flat array in 16-byte
// vectors: 8 elements a thread (one 16-byte load of bf16, two of f32),
// 256 threads a block, a grid sized from the element count (at most
// BLOCKS_PER_SM blocks an SM, in ops.py) with a grid-stride loop, and the
// elements past the last whole vector one a thread.  An instance of one
// element a thread runs where a pointer is not on 16 bytes.
//   sq_norm: each thread sums its elements' squares in f64; a block joins
//     its threads (a butterfly over each warp, then the warps in order)
//     into a partial in a workspace, and sq_norm_join_kernel sums the
//     partials in order into out[index].
//   factored_stats: the leaf as (L, R, C).  factored_partial_kernel takes
//     a tile of ROWS rows by COLS columns (a warp a row at a time, 8
//     columns a lane): a row's partial over the tile by a butterfly, and
//     each column's partial over the tile's rows, the warps joined in
//     order through shared memory, into f64 workspaces.
//     factored_finish_kernel sums each row's and each column's partials in
//     order, updates vr and vc, and leaves a partial of sum(vc) per block;
//     factored_denom_kernel sums those into denom = max(mean(vc), 1e-30).
//     Three launches behind one entry point; none uses atomics.
//   adamw_update: the update of each element from its p, g, m and v, or
//     from vr[row], vc[col] and denom[l] (v^ = vr vc / denom / (1 - b2^t),
//     never stored).  The factored instance with vectors needs C whole
//     vectors, so a vector never crosses a row.

#include "kernel_common.cuh"

namespace {

using kernel_common::from_f32;
using kernel_common::to_f32;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 8;           // elements a thread moves at once (ops.py VEC)
constexpr int ROWS = 128;        // factored_stats: rows of a tile (ops.py ROWS)
constexpr int COLS = 32 * VEC;   // factored_stats: columns of a tile, a warp wide (ops.py COLS)
static_assert(COLS == THREADS, "a tile's columns are joined one a thread");

struct Hyper {
    float b1, omb1, b2, omb2, eps, wd;  // 1 - b1 and 1 - b2 rounded to f32, as the plain version's scalars
};

// VEC elements at p (16-byte aligned), widened to f32.
__device__ __forceinline__ void load_vec(const float* p, float (&f)[VEC]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&f)[VEC]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
}

// f rounded to the element type and stored at p (16-byte aligned).
__device__ __forceinline__ void store_vec(float* p, const float (&f)[VEC]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&f)[VEC]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        w[i] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(f[2 * i])))
               | (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1]))) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The clipped gradient: f32(g) * scale, rounded to g's dtype, widened.
template <typename T>
__device__ __forceinline__ float clip(float g, float scale) {
    return to_f32(from_f32<T>(__fmul_rn(g, scale)));
}

// m_new = m * b1 + g * (1 - b1)
__device__ __forceinline__ float first_moment(float m, float g, const Hyper& h) {
    return __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.omb1));
}

// v_new = v * b2 + (g * (1 - b2)) * g
__device__ __forceinline__ float second_moment(float v, float g, const Hyper& h) {
    return __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, h.omb2), g));
}

// p - lr * (m_new / (1 - b1^t) / (sqrt(v^) + eps) [+ wd * p])
__device__ __forceinline__ float new_param(float p, float m_new, float v_hat, const Hyper& h, float lr, float bc1,
                                           int decay) {
    float upd = __fdiv_rn(__fdiv_rn(m_new, bc1), __fadd_rn(__fsqrt_rn(v_hat), h.eps));
    if (decay) upd = __fadd_rn(upd, __fmul_rn(h.wd, p));
    return __fsub_rn(p, __fmul_rn(upd, lr));
}

// The sum of x over the block, in an order fixed by the block's shape: a
// butterfly over each warp, then the warps in order.  Valid in thread 0.
__device__ __forceinline__ double block_sum(double x, double* shared /* [WARPS] */) {
#pragma unroll
    for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if ((threadIdx.x & 31) == 0) shared[threadIdx.x >> 5] = x;
    __syncthreads();
    double s = 0.0;
    if (threadIdx.x == 0)
        for (int w = 0; w < WARPS; ++w) s += shared[w];
    return s;
}

// ------------------------------------------------------------- sq_norm
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS) sq_norm_partial_kernel(const T* __restrict__ g, double* __restrict__ ws,
                                                                   int64_t n) {
    __shared__ double shared[WARPS];
    const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    const int64_t nvec = VECTOR ? n / VEC : 0;
    double acc = 0.0;
    for (int64_t i = first; i < nvec; i += stride) {
        float f[VEC];
        load_vec(g + i * VEC, f);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const double x = f[k];
            acc += x * x;  // exact in f64
        }
    }
    for (int64_t e = nvec * VEC + first; e < n; e += stride) {
        const double x = to_f32(g[e]);
        acc += x * x;
    }
    const double s = block_sum(acc, shared);
    if (threadIdx.x == 0) ws[blockIdx.x] = s;
}

__global__ void __launch_bounds__(THREADS) sq_norm_join_kernel(const double* __restrict__ ws, int blocks,
                                                                double* __restrict__ out, int64_t index) {
    __shared__ double shared[WARPS];
    double acc = 0.0;
    for (int b = threadIdx.x; b < blocks; b += THREADS) acc += ws[b];
    const double s = block_sum(acc, shared);
    if (threadIdx.x == 0) out[index] = s;
}

// ------------------------------------------------------ factored_stats
// grid (column tiles, row slabs, L).  row_ws[(l * ctiles + tile) * R + r]
// and col_ws[(l * rslabs + slab) * C + c] hold the tile's partial sums of
// the clipped g^2.
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS) factored_partial_kernel(
    const T* __restrict__ g, const float* __restrict__ scal, double* __restrict__ row_ws,
    double* __restrict__ col_ws, int64_t R, int64_t C) {
    __shared__ double cols[WARPS][COLS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t l = blockIdx.z, tile = blockIdx.x, slab = blockIdx.y;
    const int64_t ctiles = gridDim.x, rslabs = gridDim.y;
    const int64_t c0 = tile * COLS + lane * VEC, r0 = slab * ROWS;
    const T* gl = g + l * R * C;
    const float scale = scal[0];
    double col[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) col[k] = 0.0;
    for (int rr = warp; rr < ROWS && r0 + rr < R; rr += WARPS) {  // a warp's rows: the same for its lanes
        const int64_t r = r0 + rr;
        float f[VEC];
        if (VECTOR && c0 + VEC <= C) {
            load_vec(gl + r * C + c0, f);
        } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) f[k] = c0 + k < C ? to_f32(gl[r * C + c0 + k]) : 0.f;
        }
        double row = 0.0;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const double x = clip<T>(f[k], scale);
            col[k] += x * x;
            row += x * x;
        }
#pragma unroll
        for (int o = 16; o; o >>= 1) row += __shfl_xor_sync(0xffffffffu, row, o);
        if (lane == 0) row_ws[(l * ctiles + tile) * R + r] = row;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) cols[warp][lane * VEC + k] = col[k];
    __syncthreads();
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s += cols[w][threadIdx.x];
    const int64_t c = tile * COLS + threadIdx.x;
    if (c < C) col_ws[(l * rslabs + slab) * C + c] = s;
}

// grid (max(row blocks, cblocks), L, 2): z 0 updates vr, z 1 updates vc and
// leaves dpart[l * cblocks + block], its block's partial of sum(vc).
__global__ void __launch_bounds__(THREADS) factored_finish_kernel(
    const double* __restrict__ row_ws, const double* __restrict__ col_ws, float* __restrict__ vr,
    float* __restrict__ vc, double* __restrict__ dpart, Hyper h, int64_t R, int64_t C, int ctiles, int rslabs,
    int cblocks) {
    __shared__ double shared[WARPS];
    const int64_t l = blockIdx.y;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (blockIdx.z == 0) {
        if (i < R) {
            double s = 0.0;
            for (int t = 0; t < ctiles; ++t) s += row_ws[(l * ctiles + t) * R + i];
            const float mean = __fdiv_rn(static_cast<float>(s), static_cast<float>(C));
            vr[l * R + i] = __fadd_rn(__fmul_rn(vr[l * R + i], h.b2), __fmul_rn(mean, h.omb2));
        }
        return;
    }
    if (static_cast<int>(blockIdx.x) >= cblocks) return;  // the whole block
    double v = 0.0;
    if (i < C) {
        double s = 0.0;
        for (int t = 0; t < rslabs; ++t) s += col_ws[(l * rslabs + t) * C + i];
        const float mean = __fdiv_rn(static_cast<float>(s), static_cast<float>(R));
        const float x = __fadd_rn(__fmul_rn(vc[l * C + i], h.b2), __fmul_rn(mean, h.omb2));
        vc[l * C + i] = x;
        v = x;
    }
    const double s = block_sum(v, shared);
    if (threadIdx.x == 0) dpart[l * cblocks + blockIdx.x] = s;
}

// grid (L): denom[l] = max(sum(vc[l]) / C, 1e-30).
__global__ void __launch_bounds__(THREADS) factored_denom_kernel(const double* __restrict__ dpart, int cblocks,
                                                                  float* __restrict__ denom, int64_t C) {
    __shared__ double shared[WARPS];
    const int64_t l = blockIdx.x;
    double acc = 0.0;
    for (int b = threadIdx.x; b < cblocks; b += THREADS) acc += dpart[l * cblocks + b];
    const double s = block_sum(acc, shared);
    if (threadIdx.x == 0) denom[l] = fmaxf(__fdiv_rn(static_cast<float>(s), static_cast<float>(C)), 1e-30f);
}

// -------------------------------------------------------- adamw_update
template <typename T, typename TM, bool FACTORED, bool VECTOR>
__global__ void __launch_bounds__(THREADS) adamw_update_kernel(
    T* __restrict__ p, const T* __restrict__ g, TM* __restrict__ m, float* __restrict__ v,
    const float* __restrict__ vr, const float* __restrict__ vc, const float* __restrict__ denom,
    const float* __restrict__ scal, Hyper h, int decay, int64_t n, int64_t R, int64_t C) {
    const float scale = scal[0], lr = scal[1], bc1 = scal[2], bc2 = scal[3];
    const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    const int64_t nvec = VECTOR ? n / VEC : 0;
    for (int64_t i = first; i < nvec; i += stride) {
        const int64_t e = i * VEC;
        float pf[VEC], gf[VEC], mf[VEC], vf[VEC];
        load_vec(p + e, pf);
        load_vec(g + e, gf);
        load_vec(m + e, mf);
        int64_t row = 0, col = 0, l = 0;
        float vrow = 0.f, den = 1.f;
        if constexpr (FACTORED) {  // the vector lies in one row: C is whole vectors
            row = e / C, col = e - row * C, l = row / R;
            vrow = vr[row], den = denom[l];
        } else {
            load_vec(v + e, vf);
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const float gc = clip<T>(gf[k], scale);
            const float m_new = first_moment(mf[k], gc, h);
            float v_hat;
            if constexpr (FACTORED) {
                v_hat = __fdiv_rn(__fdiv_rn(__fmul_rn(vrow, vc[l * C + col + k]), den), bc2);
            } else {
                vf[k] = second_moment(vf[k], gc, h);
                v_hat = __fdiv_rn(vf[k], bc2);
            }
            mf[k] = m_new;
            pf[k] = new_param(pf[k], m_new, v_hat, h, lr, bc1, decay);
        }
        store_vec(p + e, pf);
        store_vec(m + e, mf);
        if constexpr (!FACTORED) store_vec(v + e, vf);
    }
    for (int64_t e = nvec * VEC + first; e < n; e += stride) {
        const float pf = to_f32(p[e]);
        const float gc = clip<T>(to_f32(g[e]), scale);
        const float m_new = first_moment(to_f32(m[e]), gc, h);
        float v_hat;
        if constexpr (FACTORED) {
            const int64_t row = e / C, col = e - row * C, l = row / R;
            v_hat = __fdiv_rn(__fdiv_rn(__fmul_rn(vr[row], vc[l * C + col]), denom[l]), bc2);
        } else {
            const float v_new = second_moment(v[e], gc, h);
            v[e] = v_new;
            v_hat = __fdiv_rn(v_new, bc2);
        }
        m[e] = from_f32<TM>(m_new);
        p[e] = from_f32<T>(new_param(pf, m_new, v_hat, h, lr, bc1, decay));
    }
}

// Each kernel instance is launched at one site (kernels.TRACE_SYMBOLS
// counts a replay's launches by name).
template <typename T, bool VECTOR>
cudaError_t launch_sq_norm(const void* g, double* ws, double* out, int64_t index, int64_t n, int blocks,
                           cudaStream_t stream) {
    sq_norm_partial_kernel<T, VECTOR><<<blocks, THREADS, 0, stream>>>(static_cast<const T*>(g), ws, n);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    sq_norm_join_kernel<<<1, THREADS, 0, stream>>>(ws, blocks, out, index);
    return cudaGetLastError();
}

template <typename T, bool VECTOR>
cudaError_t launch_factored(const void* g, const float* scal, float* vr, float* vc, float* denom, double* row_ws,
                            double* col_ws, double* dpart, Hyper h, int64_t L, int64_t R, int64_t C,
                            cudaStream_t stream) {
    const int ctiles = static_cast<int>((C + COLS - 1) / COLS), rslabs = static_cast<int>((R + ROWS - 1) / ROWS);
    const int cblocks = static_cast<int>((C + THREADS - 1) / THREADS);
    const int rblocks = static_cast<int>((R + THREADS - 1) / THREADS);
    const dim3 tiles(ctiles, rslabs, static_cast<unsigned>(L));
    factored_partial_kernel<T, VECTOR><<<tiles, THREADS, 0, stream>>>(static_cast<const T*>(g), scal, row_ws, col_ws,
                                                                       R, C);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const dim3 finish(rblocks > cblocks ? rblocks : cblocks, static_cast<unsigned>(L), 2);
    factored_finish_kernel<<<finish, THREADS, 0, stream>>>(row_ws, col_ws, vr, vc, dpart, h, R, C, ctiles, rslabs,
                                                           cblocks);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    factored_denom_kernel<<<static_cast<unsigned>(L), THREADS, 0, stream>>>(dpart, cblocks, denom, C);
    return cudaGetLastError();
}

struct UpdateArgs {
    void* p;
    const void* g;
    void* m;
    float* v;
    const float *vr, *vc, *denom, *scal;
    Hyper h;
    int decay;
    int64_t n, R, C;
    int blocks;
};

template <typename T, typename TM, bool FACTORED, bool VECTOR>
cudaError_t launch_update(const UpdateArgs& a, cudaStream_t stream) {
    adamw_update_kernel<T, TM, FACTORED, VECTOR><<<a.blocks, THREADS, 0, stream>>>(
        static_cast<T*>(a.p), static_cast<const T*>(a.g), static_cast<TM*>(a.m), a.v, a.vr, a.vc, a.denom, a.scal,
        a.h, a.decay, a.n, a.R, a.C);
    return cudaGetLastError();
}

template <typename T, typename TM>
cudaError_t launch_update_m(int factored, int vector, const UpdateArgs& a, cudaStream_t stream) {
    if (factored)
        return vector ? launch_update<T, TM, true, true>(a, stream) : launch_update<T, TM, true, false>(a, stream);
    return vector ? launch_update<T, TM, false, true>(a, stream) : launch_update<T, TM, false, false>(a, stream);
}

template <typename T>
cudaError_t launch_update_p(int mdtype, int factored, int vector, const UpdateArgs& a, cudaStream_t stream) {
    if (mdtype == 0) return launch_update_m<T, float>(factored, vector, a, stream);
    if (mdtype == 1) return launch_update_m<T, __nv_bfloat16>(factored, vector, a, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (g's, and p's in adamw_update); mdtype the
// same for m.  Each returns the launches' cudaError_t.

int adamw_sq_norm(int dtype, const void* g, double* ws, double* out, int64_t index, int64_t n, int blocks, int vector,
                  void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return vector ? launch_sq_norm<float, true>(g, ws, out, index, n, blocks, s)
                      : launch_sq_norm<float, false>(g, ws, out, index, n, blocks, s);
    if (dtype == 1)
        return vector ? launch_sq_norm<__nv_bfloat16, true>(g, ws, out, index, n, blocks, s)
                      : launch_sq_norm<__nv_bfloat16, false>(g, ws, out, index, n, blocks, s);
    return cudaErrorInvalidValue;
}

int adamw_factored_stats(int dtype, const void* g, const float* scal, float* vr, float* vc, float* denom,
                         double* row_ws, double* col_ws, double* dpart, float b2, float omb2, int64_t L, int64_t R,
                         int64_t C, int vector, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Hyper h{0.f, 0.f, b2, omb2, 0.f, 0.f};
    if (dtype == 0)
        return vector ? launch_factored<float, true>(g, scal, vr, vc, denom, row_ws, col_ws, dpart, h, L, R, C, s)
                      : launch_factored<float, false>(g, scal, vr, vc, denom, row_ws, col_ws, dpart, h, L, R, C, s);
    if (dtype == 1)
        return vector
                   ? launch_factored<__nv_bfloat16, true>(g, scal, vr, vc, denom, row_ws, col_ws, dpart, h, L, R, C, s)
                   : launch_factored<__nv_bfloat16, false>(g, scal, vr, vc, denom, row_ws, col_ws, dpart, h, L, R, C,
                                                           s);
    return cudaErrorInvalidValue;
}

int adamw_update(int dtype, int mdtype, int factored, void* p, const void* g, void* m, float* v, const float* vr,
                 const float* vc, const float* denom, const float* scal, float b1, float omb1, float b2, float omb2,
                 float eps, float wd, int decay, int64_t n, int64_t R, int64_t C, int blocks, int vector,
                 void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const UpdateArgs a{p, g, m, v, vr, vc, denom, scal, Hyper{b1, omb1, b2, omb2, eps, wd}, decay, n, R, C, blocks};
    if (dtype == 0) return launch_update_p<float>(mdtype, factored, vector, a, s);
    if (dtype == 1) return launch_update_p<__nv_bfloat16>(mdtype, factored, vector, a, s);
    return cudaErrorInvalidValue;
}

const char* adamw_error_string(int status) { return cudaGetErrorString(static_cast<cudaError_t>(status)); }

}  // extern "C"
