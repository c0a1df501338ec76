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
// on the order of its max, so the scale is bit-exact too.
//
// What bounds it on an H100: it moves T*C*(in + 1) + 4C bytes (quantize) or
// T*C*(1 + out) + 4C (dequantize) and does a few operations per element, so
// device memory bounds it: a 16 x 81920 float16 serve block moves 3.9 MB,
// about 1.2 us at 3.35 TB/s.
//
// Design.  The TPU kernel keeps a whole (T, block_c) column tile in VMEM,
// reduces it and quantizes it in one grid step.  Here one block of 8 warps
// owns 64 channels and all T rows: each lane holds 2 channels (lane and
// lane + 32), so a warp reads 32 consecutive elements of a row per load
// (coalesced along C), and the 8 warps take every 8th row.  Pass 1 keeps a
// running absmax per thread and joins the 8 warps in shared memory; pass 2
// reads the rows again (from L2 at the serve path's sizes) and writes q.
// The reference wrapper pads C to a multiple of 128; here the ragged C edge
// is masked in the kernel, so no padded copy is made.  Dequantize is
// element-wise: a block owns 64 channels by 32 rows, the scale held in a
// register per channel.  Loads are one element a lane; 16-byte loads are
// later work.

#include "kernel_common.cuh"

namespace {

using kernel_common::from_f32;
using kernel_common::to_f32;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int CPL = 2;             // channels per lane
constexpr int CT = 32 * CPL;       // channels per block
constexpr int RPW = 4;             // dequantize: rows per warp
constexpr int RB = WARPS * RPW;    // dequantize: rows per block

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                int64_t rows, int C, int64_t ldx) {
    __shared__ float red[WARPS][CT];
    __shared__ float sscale[CT];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int c0 = blockIdx.x * CT;

    float amax[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) amax[j] = 0.f;
#pragma unroll 4
    for (int64_t r = warp; r < rows; r += WARPS) {
        const T* row = x + r * ldx;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
            const int c = c0 + lane + 32 * j;
            if (c < C) amax[j] = fmaxf(amax[j], fabsf(to_f32(row[c])));
        }
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j) red[warp][lane + 32 * j] = amax[j];
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
            const int i = lane + 32 * j;
            float m = red[0][i];
#pragma unroll
            for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w][i]);
            const float s = m > 0.f ? m / 127.0f : 1.0f;  // IEEE division, as numpy's
            sscale[i] = s;
            if (c0 + i < C) scale[c0 + i] = s;
        }
    }
    __syncthreads();

    float s[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) s[j] = sscale[lane + 32 * j];
#pragma unroll 4
    for (int64_t r = warp; r < rows; r += WARPS) {
        const T* row = x + r * ldx;
        int8_t* qrow = q + r * (int64_t)C;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
            const int c = c0 + lane + 32 * j;
            if (c < C) {
                const float t = rintf(to_f32(row[c]) / s[j]);  // half to even
                qrow[c] = static_cast<int8_t>(fminf(fmaxf(t, -127.f), 127.f));
            }
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale, T* __restrict__ out,
                  int64_t rows, int C) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int c0 = blockIdx.x * CT;
    float s[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
        const int c = c0 + lane + 32 * j;
        s[j] = c < C ? scale[c] : 0.f;
    }
    for (int64_t r0 = (int64_t)blockIdx.y * RB; r0 < rows; r0 += (int64_t)gridDim.y * RB) {
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
            const int64_t r = r0 + warp + WARPS * i;
            if (r >= rows) break;
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
                const int c = c0 + lane + 32 * j;
                if (c < C) out[r * C + c] = from_f32<T>(static_cast<float>(q[r * C + c]) * s[j]);
            }
        }
    }
}

template <typename T>
int launch_quantize(const void* x, void* q, void* scale, int64_t rows, int C, int64_t ldx,
                    cudaStream_t stream) {
    dim3 grid((C + CT - 1) / CT);
    quantize_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x), static_cast<int8_t*>(q),
                                                     static_cast<float*>(scale), rows, C, ldx);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dequantize(const void* q, const void* scale, void* out, int64_t rows, int C,
                      cudaStream_t stream) {
    const int64_t row_blocks = (rows + RB - 1) / RB;
    dim3 grid((C + CT - 1) / CT, (unsigned)(row_blocks < 65535 ? row_blocks : 65535));
    dequantize_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const int8_t*>(q),
                                                       static_cast<const float*>(scale),
                                                       static_cast<T*>(out), rows, C);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16.  x (rows, C) with unit stride
// over C and row stride ldx (elements); q (rows, C) int8 and scale (C,)
// float32, both contiguous.  Returns the cudaError_t of the launch.
int kv_codec_quantize(int dtype, const void* x, void* q, void* scale, int64_t rows, int C,
                      int64_t ldx, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_quantize<float>(x, q, scale, rows, C, ldx, s);
        case 1: return launch_quantize<__nv_bfloat16>(x, q, scale, rows, C, ldx, s);
        case 2: return launch_quantize<__half>(x, q, scale, rows, C, ldx, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// dtype: the output's, codes as above.  q (rows, C) int8, scale (C,)
// float32 and out (rows, C), all contiguous.
int kv_codec_dequantize(int dtype, const void* q, const void* scale, void* out, int64_t rows, int C,
                        void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_dequantize<float>(q, scale, out, rows, C, s);
        case 1: return launch_dequantize<__nv_bfloat16>(q, scale, out, rows, C, s);
        case 2: return launch_dequantize<__half>(q, scale, out, rows, C, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* kv_codec_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
