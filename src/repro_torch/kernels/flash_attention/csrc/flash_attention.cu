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
// time.  At long prompts the Q·Kᵀ and P·V products make it compute bound
// (S 4096, 40 heads of 128: 172 GFLOP, 0.17 ms at the bf16 tensor peak).
//
// The TPU kernel walks a sequential grid axis over key blocks and carries
// (m, l, acc) in VMEM scratch between grid steps.  Blocks on a GPU run in
// no order, so here one thread block owns one (b, h, query tile) and loops
// over 64-key tiles itself, up to the last key its causal rows can see
// (fully masked tiles are never loaded).  Ragged query and key edges are
// masked in the kernel, so the wrapper makes no padded copies; batch and
// sequence strides come from the caller, so a slice of the KV cache is
// read in place.  Two instances:
//
// bf16: tensor cores (flash_bf16_kernel).  A block of two warpgroups owns
// 128 query rows, 64 per warpgroup.  Q·Kᵀ is wgmma m64n64k16 with Q and K
// from shared memory (128-byte swizzle, see wgmma.cuh); the scores stay
// in f32 registers for the online softmax (exp2 of log2-scaled scores).
// P·V is wgmma m64nDVk16 with P from registers and V read transposed from
// shared memory, into an f32 accumulator in registers.  P is split into
// P_hi = bf16(P) and P_lo = bf16(P - P_hi), two products against the same
// V tile: a P rounded to bf16 alone loses 2^-9 per term, and where an
// output cancels to near zero that breaks the 1e-4 + 2^-6|ref| limit the
// kernel is held to (22x over it at the serve shape, in a model of this
// tile loop on the CPU, ``ref.py::flash_tiles_plain``); hi + lo keeps
// ~2^-17, as close to the plain version as an f32 P.  So the kernel does
// 1.5x the tensor work of a bf16-P flash kernel.  K and V tiles arrive by
// cp.async into a ring of two shared-memory stages, tile j+1 in flight
// while tile j computes.  Two blocks share an SM, so that one block's
// softmax runs while the other's products hold the tensor cores.  Causal blocks are launched heaviest first (the
// query tile index runs backwards over the grid's slowest axis), so the
// short tiles fill the tail.
//
// f32: FMA units (flash_fwd_kernel), kept for the f32 weights: TF32 keeps
// ~10 bits and would break the 1e-4 limit.  One block of 128 threads owns
// 64 query rows as a 16 x 8 grid, each thread a 4 x 8 block of scores and
// a 4 x (DV/8) block of the accumulator; Q, K, V tiles staged in shared
// memory with 16-byte loads, P through a shared f32 tile.
//
// Head dims (instances at the end): 32, 64, 128, MLA's (96, 64) and 112
// (kimi-k2's 7168 / 64).  A head dim that is no multiple of 64 fills its
// last swizzled 64-column block in part: Q·Kᵀ's k-steps of 16 stop at D,
// so they read only the copied columns, and P·V runs at the next wgmma
// width (n128 for 112) over V columns zero-filled in shared memory past
// DV (cp.async with a zero source size), whose output columns are never
// stored.

#include "kernel_common.cuh"
#include "wgmma.cuh"

#include <type_traits>

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

// ---------------------------------------------------------------- bf16: wgmma
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BQ = 128;             // query rows per block: two warpgroups of 64
constexpr int BK = 64;              // keys per tile
constexpr int THREADS = 256;
constexpr int STAGES = 2;           // K/V ring depth
// two blocks per SM (registers capped at 128 a thread): one block's softmax
// runs while the other's products hold the tensor cores.  At D 128 the
// kernel needs the cap to get there, and ran faster on the H100 with it
// than at one block per SM; at D <= 96 it fits 128 registers either way
// (PERF.md, Findings).
constexpr int MIN_BLOCKS = 2;
constexpr float LOG2E = 1.4426950408889634f;

// column blocks of 64 in a swizzled tile (wgmma.cuh) and the P·V width:
// DV 32 runs as n64 and DV 112 as n128, over V columns zero-filled past
// DV, their upper output columns discarded (each output column depends
// on its own V column only)
template <int D> struct Blocks { static constexpr int value = (D + 63) / 64; };
template <int DV> struct PvN { static constexpr int value = DV <= 64 ? 64 : 128; };

template <int D, int DV>
constexpr size_t smem_bytes() {
    return 1024  // alignment slack: swizzled blocks start on 1024 bytes
         + sizeof(bf16) * 64 * ((size_t)Blocks<D>::value * BQ
                                + (size_t)STAGES * (Blocks<D>::value + Blocks<DV>::value) * BK);
}

// copy ROWS rows of COLS elements (row r at src + r * stride) into a
// swizzled tile of ROWS rows, 16 bytes per cp.async, and zero-fill its
// columns COLS..FILL-1; rows at or past n_rows are zero-filled and read
// nothing
template <int ROWS, int COLS, int FILL = COLS>
__device__ __forceinline__ void load_async(bf16* dst, const bf16* src, int64_t stride, int n_rows, int tid) {
    static_assert(COLS % 8 == 0 && FILL >= COLS && FILL % 8 == 0, "whole 16-byte chunks");
    constexpr int CPR = FILL / 8;  // 16-byte chunks per row
    constexpr int N = ROWS * CPR;
#pragma unroll
    for (int i = tid; i < N; i += THREADS) {
        const int r = i / CPR, c = (i % CPR) * 8;
        const bool ok = r < n_rows && c < COLS;
        kernel_common::cp_async16(dst + wgmma::swz(r, c, ROWS), ok ? src + r * stride + c : src, ok ? 16 : 0);
    }
}

// 2^x to ~2 ulp, denormal results flushed to zero (a weight under 2^-126
// of the row's largest is 0 to the f32 sums anyway); 2^-inf = 0
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

template <int NV>
__device__ __forceinline__ void mma_pv(float (&o)[NV / 2], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (NV == 64) wgmma::mma_rs_n64(o, a, db, 1);
    else wgmma::mma_rs_n128(o, a, db, 1);
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                  bf16* __restrict__ o, int H, int KVH, int Sq, int Skv,
                  int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                  int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                  int causal, int q_offset, float scale) {
    constexpr int DB = Blocks<D>::value, DVB = Blocks<DV>::value, NV = PvN<DV>::value;
    constexpr int Q_ELEMS = DB * BQ * 64, K_ELEMS = DB * BK * 64, V_ELEMS = DVB * BK * 64;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    bf16* Ks = Qs + Q_ELEMS;                  // [STAGES][K_ELEMS]
    bf16* Vs = Ks + STAGES * K_ELEMS;         // [STAGES][V_ELEMS]

    const int h = blockIdx.x, b = blockIdx.y;
    const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest causal tiles first
    const int kvh = h / (H / KVH);
    const int tid = threadIdx.x;
    // the warpgroup index through a shuffle, so the compiler sees it is the
    // same across each warp: a branch on it is not divergent, and wgmma in
    // it is not serialized
    const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
    const int warp = (tid % 128) / 32, lane = tid % 32;

    const bf16* qb = q + b * q_sb + (int64_t)h * D + (int64_t)q0 * q_ss;
    const bf16* kb = k + b * k_sb + (int64_t)kvh * D;
    const bf16* vb = v + b * v_sb + (int64_t)kvh * DV;

    // keys the block's rows can see, and this warpgroup's rows
    const int rows_end = min(q0 + BQ, Sq);
    const int kv_end = causal ? min(Skv, q_offset + rows_end) : Skv;
    const int n_tiles = (kv_end + BK - 1) / BK;
    const int wq0 = q0 + 64 * wg;  // first row of this warpgroup
    int wg_tiles = 0;
    if (wq0 < Sq) {
        const int wg_end = causal ? min(Skv, q_offset + min(wq0 + 64, Sq)) : Skv;
        wg_tiles = (wg_end + BK - 1) / BK;
    }

    auto load_kv = [&](int tile) {
        const int k0 = tile * BK, st = tile % STAGES;
        load_async<BK, D>(Ks + st * K_ELEMS, kb + (int64_t)k0 * k_ss, k_ss, Skv - k0, tid);
        load_async<BK, DV, NV>(Vs + st * V_ELEMS, vb + (int64_t)k0 * v_ss, v_ss, Skv - k0, tid);
    };
    load_async<BQ, D>(Qs, qb, q_ss, Sq - q0, tid);
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
        if (t < n_tiles) load_kv(t);
        kernel_common::cp_async_commit();  // Q rides in the first group
    }

    // this thread's two rows (wgmma accumulator layout) and their state
    const int r_lo = wq0 + 16 * warp + lane / 4;      // and r_lo + 8
    const int pos_lo = q_offset + r_lo;
    const float sl2 = scale * LOG2E;
    float m_lo = -1e30f, m_hi = -1e30f, l_lo = 0.f, l_hi = 0.f;  // l: this thread's columns only
    float acc[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) acc[i] = 0.f;

    const uint64_t dq = wgmma::desc(Qs + wg * 64 * 64, 16, 1024);
    const uint64_t dk0 = wgmma::desc(Ks, 16, 1024);
    const uint64_t dv0 = wgmma::desc(Vs, BK * 128, 1024);

    for (int j = 0; j < n_tiles; ++j) {
        kernel_common::cp_async_wait<STAGES - 2>();
        wgmma::fence_proxy_async();
        __syncthreads();  // tile j landed for every thread; tile j-1's stage is free
        const bool active = j < wg_tiles;  // false: every row of this warpgroup is past this tile
        const int k0 = j * BK, st = j % STAGES;
        // S = Q·Kᵀ, 64 x 64 per warpgroup, issued before the next tile's
        // copies so that their address arithmetic runs beside the product
        float s[32];
        if (active) {
            wgmma::fence();
            const uint64_t dk = dk0 + ((uint64_t)(st * K_ELEMS * 2) >> 4);
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const uint32_t q_off = ((kk / 4) * BQ * 128 + (kk % 4) * 32) >> 4;
                const uint32_t k_off = ((kk / 4) * BK * 128 + (kk % 4) * 32) >> 4;
                wgmma::mma_ss_n64(s, dq + q_off, dk + k_off, kk > 0);  // kk 0 overwrites s
            }
            wgmma::commit();
        }
        if (j + STAGES - 1 < n_tiles) load_kv(j + STAGES - 1);
        kernel_common::cp_async_commit();
        if (!active) continue;
        wgmma::wait<0>();
        wgmma::fence_regs(s);

        // online softmax over this tile, scores in log2 units
        const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > q_offset + wq0);
        float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            float x = s[i] * sl2;
            if (edge) {
                const int col = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
                const int pos = pos_lo + ((i % 4) >= 2 ? 8 : 0);
                if (col >= Skv || (causal && col > pos)) x = -INFINITY;
            }
            s[i] = x;
            if ((i % 4) < 2) mx_lo = fmaxf(mx_lo, x);
            else mx_hi = fmaxf(mx_hi, x);
        }
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
        const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
        const float c_lo = fast_exp2(m_lo - mn_lo), c_hi = fast_exp2(m_hi - mn_hi);
        m_lo = mn_lo;
        m_hi = mn_hi;
        float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const float p = fast_exp2(s[i] - ((i % 4) < 2 ? mn_lo : mn_hi));  // masked: 0
            s[i] = p;
            if ((i % 4) < 2) sum_lo += p;
            else sum_hi += p;
        }
        l_lo = l_lo * c_lo + sum_lo;
        l_hi = l_hi * c_hi + sum_hi;
#pragma unroll
        for (int i = 0; i < NV / 2; ++i) acc[i] *= (i % 4) < 2 ? c_lo : c_hi;

        // O += P_hi·V + P_lo·V
        wgmma::fence_regs(acc);
        wgmma::fence();
        const uint64_t dv = dv0 + ((uint64_t)(st * V_ELEMS * 2) >> 4);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                // registers 8kk + 2r, 8kk + 2r + 1: rows lo/hi alternate with r,
                // columns +8 for r >= 2
                const float p0 = s[8 * kk + 2 * r], p1 = s[8 * kk + 2 * r + 1];
                const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
                hi[r] = *reinterpret_cast<const uint32_t*>(&h2);
                lo[r] = wgmma::pack_bf16(p0 - __low2float(h2), p1 - __high2float(h2));
            }
            const uint64_t dvk = dv + ((uint64_t)(kk * 16 * 128) >> 4);
            mma_pv<NV>(acc, hi, dvk);
            mma_pv<NV>(acc, lo, dvk);
        }
        wgmma::commit();
        wgmma::wait<0>();
        wgmma::fence_regs(acc);
    }
    kernel_common::cp_async_wait<0>();  // no copy outlives the block

    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
    const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
    bf16* ob = o + b * o_sb + (int64_t)h * DV;
#pragma unroll
    for (int jn = 0; jn < DV / 8; ++jn) {
        const int col = 8 * jn + 2 * (lane % 4);
        if (r_lo < Sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)r_lo * o_ss + col) =
                __floats2bfloat162_rn(acc[4 * jn] * inv_lo, acc[4 * jn + 1] * inv_lo);
        if (r_lo + 8 < Sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)(r_lo + 8) * o_ss + col) =
                __floats2bfloat162_rn(acc[4 * jn + 2] * inv_hi, acc[4 * jn + 3] * inv_hi);
    }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KVH,
           int Sq, int Skv, const int64_t* st, int causal, int q_offset, float scale,
           cudaStream_t stream) {
    const size_t smem = smem_bytes<D, DV>();
    auto kern = flash_bf16_kernel<D, DV>;
    static kernel_common::SmemGrant grant;
    cudaError_t e = grant.ensure(kern, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(H, B, (Sq + BQ - 1) / BQ);
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), H, KVH, Sq, Skv, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], causal, q_offset, scale);
    return (int)cudaGetLastError();
}

}  // namespace tc

// the kernel each dtype runs: bf16 on the tensor cores, f32 on the FMA
// units (launch() branches on it, flash_attention_design reports it)
template <typename T> constexpr bool kTensorCores = std::is_same_v<T, __nv_bfloat16>;

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KVH,
           int Sq, int Skv, const int64_t* st, int causal, int q_offset, float scale,
           cudaStream_t stream) {
    if constexpr (kTensorCores<T>) {
        return tc::launch<D, DV>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, q_offset, scale, stream);
    } else {
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
}

// (D, DV) pairs with an instance (ops.py::HEAD_DIMS): D = DV at 32, 64,
// 112 and 128, and MLA's (96, 64).
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
    if (D == 112 && DV == 112)
        return launch<T, 112, 112>(q, k, v, o, B, H, KVH, Sq, Skv, st, causal, q_offset, scale, stream);
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

// the kernel's design for a dtype (as above), the name chip_smoke.py prints
const char* flash_attention_design(int dtype) {
    const bool tensor_cores = dtype == 0 ? kTensorCores<float> : kTensorCores<__nv_bfloat16>;
    return tensor_cores ? "wgmma_m64nNk16" : "fma";
}

}  // extern "C"
