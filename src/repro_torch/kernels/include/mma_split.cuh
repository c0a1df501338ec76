// mma.sync m16n8k16 on bf16 operands, and those operands split into
// pieces for the SSD scan (kernels/mamba2); paged decode (kernels/
// decode_attention) takes mma16816 alone.
//
// An f32 value v goes into the tensor cores as up to three bf16 pieces,
// hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), which keep v
// to about 2^-9, 2^-17 and 2^-25 of itself.  A product of an A operand
// in NA pieces and a B operand in NB pieces takes the piece pairs whose
// orders (hi 0, mid 1, lo 2) sum to at most 2, each summed in f32: six
// products when both are split, three when one side holds bf16 values
// exactly (NB or NA = 1), one when both do.  That keeps every product to
// ~2^-24 of itself, as an f32 FMA would.  ``mamba2/ref.py::split_einsum``
// is the same arithmetic in plain torch.
//
// Fragment layout (PTX ISA, mma.m16n8k16 with .bf16): lane = 4·g + c.
// A (16 x 16, row-major): a0 = A[g][2c..2c+1], a1 = A[g+8][2c..],
//   a2 = A[g][2c+8..], a3 = A[g+8][2c+8..].
// B (16 x 8, k x n): b0 = B[2c..2c+1][g], b1 = B[2c+8..2c+9][g].
// C (16 x 8): c0, c1 = C[g][2c..2c+1], c2, c3 = C[g+8][2c..2c+1].
// load_a / load_b read f32 tiles from shared memory stored with k
// contiguous, A as [row][k] and B as [n][k], as float2 (row strides even;
// 8 or 24 mod 32 spreads a half-warp over the 32 banks); load_a_t /
// load_b_t read them stored the other way, A as [k][row] and B as [k][n],
// one float at a time (row strides 4 mod 32 spread a warp over the banks).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_split {

// c += A·B, one m16n8k16 product of bf16 fragments (the layout above)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as NP bf16x2 pieces, x0 in the low half of each
template <int NP>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t* out, int stride) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
        out[i * stride] = *reinterpret_cast<const uint32_t*>(&v);
        if (i + 1 < NP) {
            x0 -= __low2float(v);
            x1 -= __high2float(v);
        }
    }
}

// the A fragment of the 16 x 16 tile at ``p`` (row stride ld floats)
template <int NP>
__device__ __forceinline__ void load_a(uint32_t (&a)[NP][4], const float* p, int ld, int lane) {
    const float* q = p + (lane >> 2) * ld + 2 * (lane & 3);
    const float2 v0 = *reinterpret_cast<const float2*>(q);
    const float2 v1 = *reinterpret_cast<const float2*>(q + 8 * ld);
    const float2 v2 = *reinterpret_cast<const float2*>(q + 8);
    const float2 v3 = *reinterpret_cast<const float2*>(q + 8 * ld + 8);
    split2<NP>(v0.x, v0.y, &a[0][0], 4);
    split2<NP>(v1.x, v1.y, &a[0][1], 4);
    split2<NP>(v2.x, v2.y, &a[0][2], 4);
    split2<NP>(v3.x, v3.y, &a[0][3], 4);
}

// the B fragment of the 16 (k) x 8 (n) tile stored [n][k] at ``p``
template <int NP>
__device__ __forceinline__ void load_b(uint32_t (&b)[NP][2], const float* p, int ld, int lane) {
    const float* q = p + (lane >> 2) * ld + 2 * (lane & 3);
    const float2 v0 = *reinterpret_cast<const float2*>(q);
    const float2 v1 = *reinterpret_cast<const float2*>(q + 8);
    split2<NP>(v0.x, v0.y, &b[0][0], 2);
    split2<NP>(v1.x, v1.y, &b[0][1], 2);
}

// load_a for a tile stored [k][row]
template <int NP>
__device__ __forceinline__ void load_a_t(uint32_t (&a)[NP][4], const float* p, int ld, int lane) {
    const float* q = p + 2 * (lane & 3) * ld + (lane >> 2);
    split2<NP>(q[0], q[ld], &a[0][0], 4);
    split2<NP>(q[8], q[ld + 8], &a[0][1], 4);
    split2<NP>(q[8 * ld], q[9 * ld], &a[0][2], 4);
    split2<NP>(q[8 * ld + 8], q[9 * ld + 8], &a[0][3], 4);
}

// load_b for a tile stored [k][n]
template <int NP>
__device__ __forceinline__ void load_b_t(uint32_t (&b)[NP][2], const float* p, int ld, int lane) {
    const float* q = p + 2 * (lane & 3) * ld + (lane >> 2);
    split2<NP>(q[0], q[ld], &b[0][0], 2);
    split2<NP>(q[8 * ld], q[9 * ld], &b[0][1], 2);
}

// the A fragment of k-tile kt from accumulators laid out as C fragments
// over 8-column tiles (acc[2kt], acc[2kt + 1]): a product's result fed
// into the next product without leaving registers
template <int NP>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[NP][4], const float (&lo)[4], const float (&hi)[4]) {
    split2<NP>(lo[0], lo[1], &a[0][0], 4);
    split2<NP>(lo[2], lo[3], &a[0][1], 4);
    split2<NP>(hi[0], hi[1], &a[0][2], 4);
    split2<NP>(hi[2], hi[3], &a[0][3], 4);
}

// c += A·B over the piece pairs of order <= 2
template <int NA, int NB>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[NA][4], const uint32_t (&b)[NB][2]) {
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j)
            if (i + j <= 2) mma16816(c, a[i], b[j][0], b[j][1]);
}

}  // namespace mma_split
