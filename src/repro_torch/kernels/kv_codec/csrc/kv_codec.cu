// Per-channel symmetric int8 codec for KV-cache blocks, for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/kv_codec/kv_codec.py::quantize_kernel   (body _quant_kernel)
//   src/repro/kernels/kv_codec/kv_codec.py::dequantize_kernel (body _dequant_kernel)
// The same functions, on x flattened to (T, C):
//   scale[c] = absmax over the T rows of channel c, / 127.0 (1.0 when 0)
//   q[t, c]  = clip(round_half_even(x[t, c] / scale[c]), -127, 127)   int8
//   out      = (float)q * scale, rounded to the output dtype
// The division is IEEE (nvcc without --use_fast_math) and the rounding is
// rintf (half to even), so q matches numpy's host codec
// (core/codec.py::quantize_int8) bit for bit; the absmax does not depend
// on the order of its max, so the scale is bit-exact too, however T is cut.
//
// What bounds it on an H100: it moves T*C*(in + 1) + 4C bytes (quantize) or
// T*C*(1 + out) + 4C (dequantize) and does a few operations per element, so
// device memory bounds it: a 16 x 81920 float16 serve block moves 3.9 MB,
// about 1.2 us at 3.35 TB/s.
//
// Design.  The TPU kernel keeps a whole (T, block_c) column tile in VMEM,
// reduces it and quantizes it in one grid step.  Here a block is tx lanes
// along C by ty row groups, and a lane moves 16 bytes a load: 8 channels of
// bf16/f16 or 4 of f32, so a warp reads contiguous bytes of a row.  Where
// x's start, its row stride or C is not a whole 16-byte vector, an instance
// of one element a lane runs instead.  The ragged C edge is masked a vector
// at a time (C is a whole number of vectors in the 16-byte instance); no
// padded copy is made.  ops.py::quantize_plan picks the launch from shapes
// alone:
//   one pass (T <= 64: the serve block, the latent slab): a block holds all
//     T rows of its channel tile in registers (a row a lane up to 16 rows,
//     MAX_RPT at most), joins its row groups' absmax in shared memory (one
//     thread a channel, join_row_groups), and quantizes from registers: one
//     read, one write.  Lanes along C are cut until the grid has two
//     blocks an SM.
//   split-T (larger T): the rows are cut into slabs so that the grid fills
//     the card many times over.  quantize_absmax_kernel writes a partial
//     absmax per (slab, channel) to an f32 workspace; then
//     quantize_slab_kernel takes each channel's max over the slabs, forms
//     the scale (slab 0 writes it) and quantizes its slab.  It runs the
//     slabs last to first, so its first reads find what the first kernel
//     read last still in L2.  Two launches behind one C entry point.
// Dequantize is element-wise: a lane reads 16 bytes' worth of outputs in
// codes (8 for bf16/f16, 4 for f32), keeps those channels' scales in
// registers and walks rows in a grid-stride loop, one 16-byte store a row,
// so a warp's stores cover contiguous bytes.  The grid is about 32 blocks
// an SM, so a lane takes a few rows at most.
// Lanes hold what they load as raw words (Raw: 4 registers for 16 bytes),
// which keeps enough blocks resident on an SM.

#include "kernel_common.cuh"

namespace {

using kernel_common::from_f32;

constexpr int MAX_THREADS = 256;
constexpr int MAX_RPT = 4;  // one pass: rows a lane holds (ops.py ROWS_PER_THREAD)
constexpr int UNROLL = 4;   // split-T: rows whose loads a lane issues together (ops.py UNROLL)

// An element's bits in a 32-bit word, and back.
template <typename T> struct Bits;
template <> struct Bits<float> {
    static constexpr int WIDTH = 32;
    static __device__ __forceinline__ float get(uint32_t b) { return __uint_as_float(b); }
    static __device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
};
template <> struct Bits<__nv_bfloat16> {
    static constexpr int WIDTH = 16;
    static __device__ __forceinline__ float get(uint32_t b) { return __uint_as_float(b << 16); }
    static __device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }
};
template <> struct Bits<__half> {
    static constexpr int WIDTH = 16;
    static __device__ __forceinline__ float get(uint32_t b) {
        return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
    }
    static __device__ __forceinline__ uint32_t bits(__half x) { return __half_as_ushort(x); }
};
template <> struct Bits<int8_t> {
    static constexpr int WIDTH = 8;
    static __device__ __forceinline__ float get(uint32_t b) { return static_cast<float>(static_cast<int8_t>(b)); }
    static __device__ __forceinline__ uint32_t bits(int8_t x) { return static_cast<uint8_t>(x); }
};

// VEC elements of T as loaded, kept as raw words (4 registers for 16
// bytes) and widened to f32 one at a time: one 16-, 8- or 4-byte load, or
// one element.
template <typename T, int VEC>
struct Raw {
    static constexpr int BYTES = VEC * sizeof(T), PER = 32 / Bits<T>::WIDTH;
    static constexpr int WORDS = BYTES >= 4 ? BYTES / 4 : 1;
    static_assert(VEC == 1 || BYTES == 4 || BYTES == 8 || BYTES == 16, "one access");
    uint32_t w[WORDS];

    __device__ __forceinline__ void load(const T* __restrict__ p) {
        if constexpr (VEC == 1) {
            w[0] = Bits<T>::bits(*p);
        } else if constexpr (BYTES == 16) {
            const uint4 u = *reinterpret_cast<const uint4*>(p);
            w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
        } else if constexpr (BYTES == 8) {
            const uint2 u = *reinterpret_cast<const uint2*>(p);
            w[0] = u.x, w[1] = u.y;
        } else {
            w[0] = *reinterpret_cast<const uint32_t*>(p);
        }
    }
    __device__ __forceinline__ float operator[](int i) const {
        return Bits<T>::get(VEC == 1 ? w[0] : w[i / PER] >> (Bits<T>::WIDTH * (i % PER)));
    }
};

// f rounded to T and stored at p: one 16-byte store, or one element.
template <typename T, int VEC>
__device__ __forceinline__ void store_from_f32(T* __restrict__ p, const float (&f)[VEC]) {
    if constexpr (VEC == 1) {
        *p = from_f32<T>(f[0]);
    } else {
        static_assert(VEC * sizeof(T) == 16, "a 16-byte vector");
        constexpr int PER = 32 / Bits<T>::WIDTH;
        uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int i = 0; i < VEC; ++i)
            w[i / PER] |= Bits<T>::bits(from_f32<T>(f[i])) << (Bits<T>::WIDTH * (i % PER));
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    }
}

// VEC int8 codes (t integral in [-127, 127]) at p: one 4- or 8-byte store,
// or one code.
template <int VEC>
__device__ __forceinline__ void store_codes(int8_t* __restrict__ p, const float (&t)[VEC]) {
    if constexpr (VEC == 1) {
        *p = static_cast<int8_t>(t[0]);
    } else {
        static_assert(VEC == 4 || VEC == 8, "4 or 8 codes a store");
        uint32_t w[2] = {0, 0};
#pragma unroll
        for (int i = 0; i < VEC; ++i)
            w[i / 4] |= (static_cast<uint32_t>(static_cast<int>(t[i])) & 0xffu) << (8 * (i % 4));
        if constexpr (VEC == 4) *reinterpret_cast<uint32_t*>(p) = w[0];
        else *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    }
}

// VEC f32 values (global or shared memory): float4 accesses when VEC is a
// multiple of 4 (p on 16 bytes), else one at a time.
template <int VEC>
__device__ __forceinline__ void load_floats(const float* p, float (&f)[VEC]) {
    if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int k = 0; k < VEC; k += 4) {
            const float4 v = reinterpret_cast<const float4*>(p)[k / 4];
            f[k] = v.x, f[k + 1] = v.y, f[k + 2] = v.z, f[k + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) f[i] = p[i];
    }
}

template <int VEC>
__device__ __forceinline__ void store_floats(float* p, const float (&f)[VEC]) {
    if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int k = 0; k < VEC; k += 4)
            reinterpret_cast<float4*>(p)[k / 4] = make_float4(f[k], f[k + 1], f[k + 2], f[k + 3]);
    } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) p[i] = f[i];
    }
}

__device__ __forceinline__ float code_of(float x, float s) {
    return fminf(fmaxf(rintf(x / s), -127.f), 127.f);  // IEEE division, half to even, as numpy's
}

__device__ __forceinline__ float scale_of(float absmax) {
    return absmax > 0.f ? absmax / 127.0f : 1.0f;  // IEEE division, as numpy's
}

// Joins the block's row groups: lane (x, y) puts its VEC partial maxima in
// red[y][x * VEC + j]; after the barrier thread t takes channels t, t +
// threads, ... of the block's CH = blockDim.x * VEC and calls take(ch, max
// over the row groups).  Every thread of the block calls it; red holds
// blockDim.y * CH floats.
template <int VEC, typename Take>
__device__ __forceinline__ void join_row_groups(const float (&m)[VEC], float* red, Take take) {
    const int CH = blockDim.x * VEC, threads = blockDim.x * blockDim.y;
    store_floats<VEC>(red + threadIdx.y * CH + threadIdx.x * VEC, m);
    __syncthreads();
    for (int ch = threadIdx.y * blockDim.x + threadIdx.x; ch < CH; ch += threads) {
        float a = red[ch];
        for (int k = 1; k < (int)blockDim.y; ++k) a = fmaxf(a, red[k * CH + ch]);
        take(ch, a);
    }
}

// One pass: the block owns channels [c0, c0 + CH) and all rows (rows <=
// blockDim.y * RPT); lane (x, y) holds rows y, y + blockDim.y, ... in
// registers.  Shared memory: the join's blockDim.y * CH floats, then the
// CH scales.
template <typename T, int VEC, int RPT>
__global__ void __launch_bounds__(MAX_THREADS)
quantize_one_pass_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                         int rows, int C, int64_t ldx) {
    extern __shared__ float smem[];
    const int CH = blockDim.x * VEC, c0 = blockIdx.x * CH, c = c0 + threadIdx.x * VEC;
    const bool in = c < C;
    float* sscale = smem + blockDim.y * CH;
    Raw<T, VEC> v[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = threadIdx.y + i * blockDim.y;
        if (in && r < rows) v[i].load(x + r * ldx + c);
    }
    float m[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) m[j] = 0.f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        if (in && (int)(threadIdx.y + i * blockDim.y) < rows) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) m[j] = fmaxf(m[j], fabsf(v[i][j]));
        }
    }
    join_row_groups<VEC>(m, smem, [&](int ch, float a) {
        const float s = scale_of(a);
        sscale[ch] = s;
        if (c0 + ch < C) scale[c0 + ch] = s;
    });
    __syncthreads();
    if (!in) return;
    float s[VEC];
    load_floats<VEC>(sscale + threadIdx.x * VEC, s);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = threadIdx.y + i * blockDim.y;
        if (r < rows) {
            float t[VEC];
#pragma unroll
            for (int j = 0; j < VEC; ++j) t[j] = code_of(v[i][j], s[j]);
            store_codes<VEC>(q + (int64_t)r * C + c, t);
        }
    }
}

// Split-T, first kernel: block (tile, slab) writes the absmax of its slab's
// rows for its channels to ws[slab, c].
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
quantize_absmax_kernel(const T* __restrict__ x, float* __restrict__ ws, int64_t rows, int C, int64_t ldx,
                       int64_t slab_rows) {
    extern __shared__ float red[];
    const int CH = blockDim.x * VEC, c0 = blockIdx.x * CH, c = c0 + threadIdx.x * VEC;
    const int64_t r0 = (int64_t)blockIdx.y * slab_rows, r1 = r0 + slab_rows < rows ? r0 + slab_rows : rows;
    const int64_t step = blockDim.y;
    float m[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) m[j] = 0.f;
    if (c < C) {
        for (int64_t r = r0 + threadIdx.y; r < r1; r += UNROLL * step) {
            Raw<T, VEC> v[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                if (r + u * step < r1) v[u].load(x + (r + u * step) * ldx + c);
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                if (r + u * step < r1) {
#pragma unroll
                    for (int j = 0; j < VEC; ++j) m[j] = fmaxf(m[j], fabsf(v[u][j]));
                }
            }
        }
    }
    join_row_groups<VEC>(m, red, [&](int ch, float a) {
        if (c0 + ch < C) ws[(int64_t)blockIdx.y * C + c0 + ch] = a;
    });
}

// Split-T, second kernel: the max over the gridDim.y slabs' partials, the
// scale (written by slab 0), and the quantize of this block's slab.  Shared
// memory: the CH scales.
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
quantize_slab_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                     const float* __restrict__ ws, int64_t rows, int C, int64_t ldx, int64_t slab_rows) {
    extern __shared__ float sscale[];
    const int CH = blockDim.x * VEC, c0 = blockIdx.x * CH, c = c0 + threadIdx.x * VEC;
    const int n_slabs = gridDim.y, slab = n_slabs - 1 - blockIdx.y;  // last slab first
    const int threads = blockDim.x * blockDim.y;
    for (int ch = threadIdx.y * blockDim.x + threadIdx.x; ch < CH; ch += threads) {
        float a = 0.f;
        if (c0 + ch < C) {
            for (int k = 0; k < n_slabs; ++k) a = fmaxf(a, ws[(int64_t)k * C + c0 + ch]);
        }
        const float s = scale_of(a);
        sscale[ch] = s;
        if (slab == 0 && c0 + ch < C) scale[c0 + ch] = s;
    }
    __syncthreads();
    if (c >= C) return;
    float s[VEC];
    load_floats<VEC>(sscale + threadIdx.x * VEC, s);
    const int64_t r0 = (int64_t)slab * slab_rows, r1 = r0 + slab_rows < rows ? r0 + slab_rows : rows;
    const int64_t step = blockDim.y;
    for (int64_t r = r0 + threadIdx.y; r < r1; r += UNROLL * step) {
        Raw<T, VEC> v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            if (r + u * step < r1) v[u].load(x + (r + u * step) * ldx + c);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            if (r + u * step < r1) {
                float t[VEC];
#pragma unroll
                for (int j = 0; j < VEC; ++j) t[j] = code_of(v[u][j], s[j]);
                store_codes<VEC>(q + (r + u * step) * C + c, t);
            }
        }
    }
}

// Lane (x, y) of block (tile, b) owns channels [c, c + VEC) and rows
// b * blockDim.y + y + k * gridDim.y * blockDim.y.  VEC = 16 / sizeof(T):
// one 16-byte store a row, so a warp's stores cover contiguous bytes.
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale, T* __restrict__ out,
                  int64_t rows, int C) {
    const int c = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
    if (c >= C) return;
    float s[VEC];
    load_floats<VEC>(scale + c, s);
    const int64_t step = (int64_t)gridDim.y * blockDim.y;
    for (int64_t r = (int64_t)blockIdx.y * blockDim.y + threadIdx.y; r < rows; r += step) {
        Raw<int8_t, VEC> v;
        v.load(q + r * C + c);
        float o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) o[j] = v[j] * s[j];
        store_from_f32<T, VEC>(out + r * C + c, o);
    }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

bool block_ok(int tx, int ty) { return tx >= 1 && ty >= 1 && tx * ty <= MAX_THREADS; }

template <typename T, int VEC, int RPT>
int launch_one_pass(const T* x, int8_t* q, float* scale, int64_t rows, int C, int64_t ldx, int tx, int ty,
                    cudaStream_t stream) {
    const size_t smem = (size_t)(ty + 1) * tx * VEC * sizeof(float);
    quantize_one_pass_kernel<T, VEC, RPT><<<(unsigned)cdiv(cdiv(C, VEC), tx), dim3(tx, ty), smem, stream>>>(
        x, q, scale, (int)rows, C, ldx);
    return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_quantize(const T* x, int8_t* q, float* scale, float* ws, int64_t rows, int C, int64_t ldx, int tx,
                    int ty, int split, int64_t slab_rows, int n_slabs, cudaStream_t stream) {
    if (VEC > 1 && (reinterpret_cast<uintptr_t>(x) % 16 || ldx % VEC || C % VEC)) return (int)cudaErrorInvalidValue;
    if (!split) {
        const int64_t rpt = cdiv(rows, ty);
        if (rpt == 1) return launch_one_pass<T, VEC, 1>(x, q, scale, rows, C, ldx, tx, ty, stream);
        if (rpt == 2) return launch_one_pass<T, VEC, 2>(x, q, scale, rows, C, ldx, tx, ty, stream);
        if (rpt <= MAX_RPT) return launch_one_pass<T, VEC, MAX_RPT>(x, q, scale, rows, C, ldx, tx, ty, stream);
        return (int)cudaErrorInvalidValue;
    }
    if (ws == nullptr || slab_rows < 1 || n_slabs < 1 || n_slabs > 65535 || (int64_t)n_slabs * slab_rows < rows ||
        (int64_t)(n_slabs - 1) * slab_rows >= rows)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)cdiv(cdiv(C, VEC), tx), (unsigned)n_slabs), block(tx, ty);
    const size_t ch_bytes = (size_t)tx * VEC * sizeof(float);
    quantize_absmax_kernel<T, VEC><<<grid, block, ty * ch_bytes, stream>>>(x, ws, rows, C, ldx, slab_rows);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    quantize_slab_kernel<T, VEC><<<grid, block, ch_bytes, stream>>>(x, q, scale, ws, rows, C, ldx, slab_rows);
    return (int)cudaGetLastError();
}

template <typename T>
int quantize_as(const void* x, void* q, void* scale, void* ws, int64_t rows, int C, int64_t ldx, int vec, int tx,
                int ty, int split, int64_t slab_rows, int n_slabs, cudaStream_t stream) {
    constexpr int WIDE = 16 / sizeof(T);
    if (rows < 1 || C < 1 || !block_ok(tx, ty)) return (int)cudaErrorInvalidValue;
    const T* xt = static_cast<const T*>(x);
    int8_t* qt = static_cast<int8_t*>(q);
    float *st = static_cast<float*>(scale), *wt = static_cast<float*>(ws);
    if (vec == WIDE)
        return launch_quantize<T, WIDE>(xt, qt, st, wt, rows, C, ldx, tx, ty, split, slab_rows, n_slabs, stream);
    if (vec == 1)
        return launch_quantize<T, 1>(xt, qt, st, wt, rows, C, ldx, tx, ty, split, slab_rows, n_slabs, stream);
    return (int)cudaErrorInvalidValue;
}

template <typename T, int VEC>
int launch_dequantize(const int8_t* q, const float* scale, T* out, int64_t rows, int C, int tx, int ty,
                      int row_blocks, cudaStream_t stream) {
    if (VEC > 1 && (reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(scale) % 16 ||
                    reinterpret_cast<uintptr_t>(out) % 16 || C % VEC))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)cdiv(cdiv(C, VEC), tx), (unsigned)row_blocks);
    dequantize_kernel<T, VEC><<<grid, dim3(tx, ty), 0, stream>>>(q, scale, out, rows, C);
    return (int)cudaGetLastError();
}

template <typename T>
int dequantize_as(const void* q, const void* scale, void* out, int64_t rows, int C, int vec, int tx, int ty,
                  int row_blocks, cudaStream_t stream) {
    constexpr int WIDE = 16 / sizeof(T);
    if (rows < 1 || C < 1 || !block_ok(tx, ty) || row_blocks < 1 || row_blocks > 65535)
        return (int)cudaErrorInvalidValue;
    const int8_t* qt = static_cast<const int8_t*>(q);
    const float* st = static_cast<const float*>(scale);
    T* ot = static_cast<T*>(out);
    if (vec == WIDE) return launch_dequantize<T, WIDE>(qt, st, ot, rows, C, tx, ty, row_blocks, stream);
    if (vec == 1) return launch_dequantize<T, 1>(qt, st, ot, rows, C, tx, ty, row_blocks, stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16.  x (rows, C) with unit stride
// over C and row stride ldx (elements); q (rows, C) int8 and scale (C,)
// float32, both contiguous; ws (n_slabs, C) float32 on the split-T path,
// else unused.  The launch as ops.py::quantize_plan gives it: vec 16 bytes'
// worth of elements or 1, a (tx, ty) block, one pass (split 0) or split-T
// over n_slabs slabs of slab_rows rows.  Returns the cudaError_t of the
// launches (cudaErrorInvalidValue for a plan that does not fit).
int kv_codec_quantize(int dtype, const void* x, void* q, void* scale, void* ws, int64_t rows, int C, int64_t ldx,
                      int vec, int tx, int ty, int split, int64_t slab_rows, int n_slabs, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return quantize_as<float>(x, q, scale, ws, rows, C, ldx, vec, tx, ty, split, slab_rows, n_slabs, s);
        case 1:
            return quantize_as<__nv_bfloat16>(x, q, scale, ws, rows, C, ldx, vec, tx, ty, split, slab_rows, n_slabs,
                                              s);
        case 2: return quantize_as<__half>(x, q, scale, ws, rows, C, ldx, vec, tx, ty, split, slab_rows, n_slabs, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// dtype: the output's, codes as above.  q (rows, C) int8, scale (C,)
// float32 and out (rows, C), all contiguous.  The launch as
// ops.py::dequantize_plan gives it: vec 16 bytes' worth of outputs (8 or
// 4 codes) or 1, a (tx, ty) block, row_blocks blocks along the rows.
int kv_codec_dequantize(int dtype, const void* q, const void* scale, void* out, int64_t rows, int C, int vec,
                        int tx, int ty, int row_blocks, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return dequantize_as<float>(q, scale, out, rows, C, vec, tx, ty, row_blocks, s);
        case 1: return dequantize_as<__nv_bfloat16>(q, scale, out, rows, C, vec, tx, ty, row_blocks, s);
        case 2: return dequantize_as<__half>(q, scale, out, rows, C, vec, tx, ty, row_blocks, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* kv_codec_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
