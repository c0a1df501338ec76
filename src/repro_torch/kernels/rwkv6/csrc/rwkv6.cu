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
// r/k/v arrive as bf16 or f32, w/u/state as f32; y goes out in f32 and the
// final state is written once.
//
// What bounds it on an H100: per chunk of C steps and head size N it does
// about 4·C·N² + 2·C²·N flops per (b, h) on C·N·(3 + 1) inputs, ~17 flops
// per byte at the model's shapes (C 16, N 64): the bytes bound it (1.4 µs
// at B 1, S 128, H 32).  The first version was bound by latency instead:
// one block per (b, h) (32 blocks) walked every chunk in series through
// six barrier-separated phases on the FMA units, ~14 µs a chunk.
//
// Design.  Only S ← exp(cum_last) ∘ S + k_remᵀ·v carries from chunk to
// chunk; everything else a chunk needs is its own, so it is formed for all
// chunks at once, and the sequential walk keeps only what the state
// touches.  Four kernels behind one entry point:
//  (i)  wkv_chunk_kernel, one block per (b, chunk, h): the clamped log w,
//       its cumulative sum (one thread a channel, in sequence order),
//       r_dec = r·exp(cum_prev), k_inv = k·exp(-cum), k_rem =
//       k·exp(cum_last - cum), the strictly lower A = r_dec·k_invᵀ and the
//       u-diagonal r·u·k, written as one record per chunk (Record).
//  (a)  wkv_group_kernel<.., false>, one block per (b, group, h, slab):
//       every group but the last walks its chunks' k_rem and exp(cum_last)
//       from a zero state to its local state and total decay.
//  (b)  wkv_pass_kernel, one thread per state entry: start_{g+1} =
//       decay_g ∘ start_g + local_g, in place of the local states.
//  (c)  wkv_group_kernel<.., true>, one block per (b, group, h, slab): the
//       group's state updates in series from its starting state, keeping
//       each chunk's start, then y = r_dec·S + A·v + diag·v for all of
//       the group's chunks at once; the last group writes the final state.
// A slab is 16 value columns of S and y: each column is its own
// recurrence, so at B 1, H 32, N 64 the walk runs in 128 blocks.  The
// chunks go in state groups (group_chunks): one group, with no pass, when
// the sequence has at most 8 chunks, else groups of 4.  Materialising a
// state per 16-step chunk would write 134 MB at S 4096, more than the
// function's own 118 MB; per group of 4 it is 33 MB.
// The records are traffic the bound does not count: 10.2 KB per (b,
// chunk, h) at chunk 16, 2.6 MB on the path and 83 MB at S 4096, written
// once, then read by each of the 4 slabs in (c) (whole) and in (a) (k_rem
// and the decay, 4.3 KB), mostly from L2 since a group's slabs run side by
// side.  A walk block loads its whole group at once (cp.async), so it
// waits for memory once, not once a chunk.  Only the state update (a
// 16-term sum per entry) carries from chunk to chunk; the 64-term r_dec·S
// of each chunk does not, so the walk runs the state updates first and
// every chunk's outputs after, in parallel, instead of paying the long
// sum's latency once a chunk.  Steps past S read as r = k = v = 0, w = 1,
// the reference's padding, so the wrapper copies nothing; batch, sequence
// and head strides come from the caller, so the model's (B, S, H, N) and
// the op's (B, H, S, N) both read in place.
//
// The products run on the FMA units from register tiles: the walk's state
// 2 x 2 entries a thread, its outputs 2 x 4 a thread, (i)'s A 2 x 2; each
// tile reads one float2 or float4 of each operand per step (two
// shared-memory loads per 4 or 8 FMAs, not per FMA).  Tiles are no larger
// because a slab's state has 1,024 entries and a chunk 256 outputs: with
// 4 x 4 tiles most of the block's threads would idle.  Every output is one
// FMA chain in the plain version's order (cuBLAS's, for its einsums), so
// the path's state is bit for bit the plain version's.  A
// tensor-core design (mma.sync m16n8k16, f32 operands in three bf16
// pieces) met the 3e-4 tolerance at under 0.1 of it, but rwkv6-1.6b's bf16
// gate in chip_smoke.py (kernel path against plain path, 5 % of max
// |logit|) reads rounding: at random weights 24 bf16 layers amplify any
// f32 rounding that differs into a ~10-16 % logit gap, an f64-exact scan's
// included (PERF.md; scripts/bf16_gate_sensitivity.py).

#include <algorithm>
#include <cstdio>
#include <initializer_list>

#include "kernel_common.cuh"


namespace {

using kernel_common::to_f32;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_N = 64;
constexpr int MAX_C = 64;
constexpr int SLAB = 16;                 // value columns per block of the walk
constexpr int ONE_GROUP = 8;             // chunks a sequence may have and still run as one state group
constexpr int GROUP = 4;                 // chunks per state group when there is more than one
constexpr size_t GROUP_SMEM = 200 << 10; // shared memory a walk block may take for its group
constexpr float LOG_CLAMP = 80.0f;

// Element strides (batch, sequence, head) of r, k, v, w and y; N is unit stride.
struct Strides {
    int64_t r[3], k[3], v[3], w[3], y[3];
};

// A chunk's record, floats: r_dec transposed [MAX_N][ldt], k_rem
// [cp][MAX_N], A transposed [cp][ldt] (A[t][j] at [j][t], j < t, else 0),
// diag [cp], exp(cum_last) [MAX_N].  cp is C rounded up to 4 (the rows past
// C are zeros); ldt = cp + 2 is even, so float2 reads are aligned, and 2
// mod 4, so (i)'s transposed writes spread over the banks.  Every part
// starts on 16 bytes.
struct Record {
    int cp, ldt, rdt, kr, at, dg, ecl, size;
    __host__ __device__ explicit Record(int C) {
        cp = (C + 3) / 4 * 4;
        ldt = cp + 2;
        rdt = 0;
        kr = MAX_N * ldt;
        at = kr + cp * MAX_N;
        dg = at + cp * ldt;
        ecl = dg + cp;
        size = ecl + MAX_N;
    }
};

struct Dims {
    int B, H, S, N, C, nc, G, ng, slabs;
    bool vec;  // r/k/v/w rows 16-byte aligned: vector copies
};

// ``rows`` x ``width`` elements of a row-major source (row stride
// ``stride``) into shared memory (row stride ``ld``), rows in [valid, rows)
// as zeros: 16-byte cp.async copies when ``vec`` (commit and wait are the
// caller's), plain loads otherwise.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src, int64_t stride, int rows, int valid,
                                          int width, bool vec, int tid) {
    if (vec) {
        constexpr int PER = 16 / sizeof(T);
        const int per_row = width / PER;
        for (int i = tid; i < rows * per_row; i += THREADS) {
            const int t = i / per_row, q = (i % per_row) * PER;
            // rows past ``valid`` copy 0 bytes (zeros) from a valid address
            kernel_common::cp_async16(dst + t * ld + q, src + (int64_t)min(t, valid - 1) * stride + q,
                                      t < valid ? 16 : 0);
        }
    } else {
        for (int i = tid; i < rows * width; i += THREADS) {
            const int t = i / width, q = i % width;
            dst[t * ld + q] = t < valid ? src[(int64_t)t * stride + q] : kernel_common::from_f32<T>(0.f);
        }
    }
}

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// acc[i][j] = fma(x[i], z[j], acc[i][j]) over a 2 x 2 tile
__device__ __forceinline__ void fma2x2(float (&acc)[2][2], float2 x, float2 z) {
    acc[0][0] = fmaf(x.x, z.x, acc[0][0]);
    acc[0][1] = fmaf(x.x, z.y, acc[0][1]);
    acc[1][0] = fmaf(x.y, z.x, acc[1][0]);
    acc[1][1] = fmaf(x.y, z.y, acc[1][1]);
}

// ------------------------------------------------------------------ (i)
template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const float* __restrict__ w,
                 const float* __restrict__ u, float* __restrict__ records, Dims d, Strides st) {
    extern __shared__ __align__(16) float sm[];
    const int C = d.C;
    const Record rec(C);
    const int ldt = rec.ldt;
    float* out = sm;                        // the record, as it goes out
    float* RDT = out + rec.rdt;             // [n][t] r_dec
    float* KR = out + rec.kr;               // [t][n] clamped log w, then k_rem
    float* AT = out + rec.at;               // [j][t] A
    float* DG = out + rec.dg;               // [t]
    float* ECL = out + rec.ecl;             // [n]
    float* KIT = out + rec.size;            // [n][t] k_inv
    float* CU = KIT + MAX_N * ldt;          // [t][n] cum
    float* CL = CU + C * MAX_N;             // [n] cum_last
    float* U = CL + MAX_N;                  // [n]
    float* W = U + MAX_N;                   // [t][n] w
    T* R = reinterpret_cast<T*>(W + C * MAX_N);  // [t][n] r
    T* K = R + C * MAX_N;                   // [t][n] k

    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const int64_t pos0 = (int64_t)c * C;
    const int valid = min(C, d.S - (int)pos0);
    const float clamp = -LOG_CLAMP / (float)C;

    copy_rows(R, MAX_N, r + b * st.r[0] + h * st.r[2] + pos0 * st.r[1], st.r[1], C, valid, d.N, d.vec, tid);
    copy_rows(K, MAX_N, k + b * st.k[0] + h * st.k[2] + pos0 * st.k[1], st.k[1], C, valid, d.N, d.vec, tid);
    copy_rows(W, MAX_N, w + b * st.w[0] + h * st.w[2] + pos0 * st.w[1], st.w[1], C, valid, d.N, d.vec, tid);
    kernel_common::cp_async_commit();
    for (int i = tid; i < MAX_N; i += THREADS) U[i] = i < d.N ? u[h * d.N + i] : 0.f;
    // the record's padding and A's upper part go out as zeros
    for (int i = tid; i < rec.size + MAX_N * ldt; i += THREADS) out[i] = 0.f;
    kernel_common::cp_async_wait<0>();
    __syncthreads();

    // the clamped log w of every (t, n); steps past S are no-ops (log 1 = 0)
    for (int i = tid; i < C * MAX_N; i += THREADS) {
        const int t = i / MAX_N, n = i % MAX_N;
        KR[i] = t < valid && n < d.N ? fmaxf(logf(fmaxf(W[i], 1e-38f)), clamp) : 0.f;
    }
    __syncthreads();
    if (tid < MAX_N) {  // the cumulative sum, one channel a thread, in sequence order
        const int n = tid;
        float cum = 0.f;
#pragma unroll 8
        for (int t = 0; t < C; ++t) {
            cum += KR[t * MAX_N + n];
            CU[t * MAX_N + n] = cum;
        }
        CL[n] = cum;
        ECL[n] = expf(cum);
    }
    __syncthreads();
    for (int i = tid; i < C * MAX_N; i += THREADS) {
        const int t = i / MAX_N, n = i % MAX_N;
        const float lw = KR[i], cu = CU[i];
        const float rr = n < d.N ? to_f32(R[i]) : 0.f, kk = n < d.N ? to_f32(K[i]) : 0.f;
        RDT[n * ldt + t] = rr * expf(cu - lw);  // exponent <= 0
        KIT[n * ldt + t] = kk * expf(-cu);      // bounded by the clamp
        KR[i] = kk * expf(CL[n] - cu);
    }
    __syncthreads();
    // A[t][j] = Σ_n r_dec[t][n]·k_inv[j][n] for j < t in 2 x 2 tiles (row
    // pair a, column pair b <= a), each entry one chain in n order; then
    // diag[t] = Σ_n (r·u)·k, one thread a row
    const int pairs = rec.cp / 2;
    const int tiles = pairs * (pairs + 1) / 2;
    for (int p = tid; p < tiles + C; p += THREADS) {
        if (p < tiles) {
            int a = 0, bj = p;
            while (bj > a) bj -= ++a;
            const int t0 = 2 * a, j0 = 2 * bj;
            float acc[2][2] = {};
#pragma unroll 8
            for (int q = 0; q < d.N; ++q) fma2x2(acc, ld2(RDT + q * ldt + t0), ld2(KIT + q * ldt + j0));
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int jj = 0; jj < 2; ++jj)
                    if (j0 + jj < t0 + i && t0 + i < C) AT[(j0 + jj) * ldt + t0 + i] = acc[i][jj];
        } else {
            const int t = p - tiles;
            float dg = 0.f;
            int q = 0;
            for (; q + 8 <= d.N; q += 8) {
                float x[8], z[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    x[i] = to_f32(R[t * MAX_N + q + i]) * U[q + i];
                    z[i] = to_f32(K[t * MAX_N + q + i]);
                }
#pragma unroll
                for (int i = 0; i < 8; ++i) dg = fmaf(x[i], z[i], dg);
            }
            for (; q < d.N; ++q) dg = fmaf(to_f32(R[t * MAX_N + q]) * U[q], to_f32(K[t * MAX_N + q]), dg);
            DG[t] = dg;
        }
    }
    __syncthreads();
    float4* dst = reinterpret_cast<float4*>(records + (((int64_t)b * d.nc + c) * d.H + h) * rec.size);
    const float4* src = reinterpret_cast<const float4*>(out);
    for (int i = tid; i < rec.size / 4; i += THREADS) dst[i] = src[i];
}

size_t chunk_smem_bytes(int C, int tbytes) {
    const Record rec(C);
    return (size_t)(rec.size + MAX_N * rec.ldt + C * MAX_N + 2 * MAX_N + C * MAX_N) * 4 +
           (size_t)2 * C * MAX_N * tbytes;
}

// ------------------------------------------------------------ (a), (c)
// Where a chunk's part of the record and its v slab sit in a walk block's
// shared memory (floats): (c) takes the whole record, (a) k_rem and
// exp(cum_last) alone.
struct Stage {
    int kr, ecl, v, size;
    __host__ __device__ Stage(const Record& rec, int C, int tbytes, bool whole) {
        kr = whole ? rec.kr : 0;
        ecl = whole ? rec.ecl : rec.cp * MAX_N;
        v = whole ? rec.size : ecl + MAX_N;
        size = v + (C * SLAB * tbytes + 15) / 16 * 4;
    }
};

// Shared memory of a walk block over G chunks: their stages, v in f32
// [G][C][SLAB] and, for (c), each chunk's starting state [G][MAX_N][SLAB].
size_t group_smem_bytes(int C, int tbytes, int G, bool whole) {
    const Stage sg(Record(C), C, tbytes, whole);
    return (size_t)G * (sg.size + C * SLAB + (whole ? MAX_N * SLAB : 0)) * 4;
}

// Chunks per state group: one group when the sequence has at most
// ONE_GROUP chunks (no state pass), else groups of GROUP; never more than
// (c)'s block holds in GROUP_SMEM at this chunk length (3 at chunk 64).
// One group of 8 takes 126 KB at chunk 16, so one block an SM: on the
// path that is the fastest, but when there are many groups, groups of 4
// run 3 blocks an SM and beat groups of 8 by ~15 % (PERF.md).
int group_chunks(int S, int C) {
    const int nc = (S + C - 1) / C;
    const int fit = std::max(1, (int)(GROUP_SMEM / group_smem_bytes(C, 4, 1, true)));
    return std::min(nc <= ONE_GROUP ? nc : GROUP, fit);
}

// kOut false: (a), the group's local state and total decay.
// kOut true: (c), y over the group's chunks from its starting state.
// The whole group is loaded at once.  Pass 1 walks the chunks' state
// updates, each thread a 2 x 2 tile of the slab's state in registers (only
// these carry from chunk to chunk); (c) keeps each chunk's starting state.
// Pass 2 ((c) only) then forms every chunk's y at once, a 2 x 4 tile
// (rows t0, t0 + 1, columns m0 .. m0 + 3) a thread.
template <typename T, bool kOut>
__global__ void __launch_bounds__(THREADS)
wkv_group_kernel(const T* __restrict__ v, const float* __restrict__ records, const float* __restrict__ s0,
                 float* __restrict__ ws_state, float* __restrict__ ws_decay, float* __restrict__ y,
                 float* __restrict__ sT, Dims d, Strides st) {
    extern __shared__ __align__(16) float sm[];
    const int C = d.C;
    const Record rec(C);
    const int ldt = rec.ldt;
    const Stage sg(rec, C, sizeof(T), kOut);
    float* VS = sm + d.G * sg.size;  // [chunk][t][m] v
    float* SS = VS + d.G * C * SLAB;  // [chunk][n][m] the chunk's starting state

    const int gi = blockIdx.x / d.slabs, ms = SLAB * (blockIdx.x % d.slabs);
    const int h = blockIdx.y, b = blockIdx.z;
    const int mw = min(SLAB, d.N - ms);
    const int tid = threadIdx.x;
    const int first = gi * d.G, count = min(d.G, d.nc - first);
    const T* vb = v + b * st.v[0] + h * st.v[2] + ms;
    const int64_t bh = (int64_t)b * d.H + h;
    const int64_t NN = (int64_t)d.N * d.N;
    const bool vvec = d.vec && (mw * sizeof(T)) % 16 == 0;

    // every chunk's record (or (a)'s part of it) and v, in one batch
    for (int ci = 0; ci < count; ++ci) {
        float* buf = sm + ci * sg.size;
        const float* src = records + (((int64_t)b * d.nc + first + ci) * d.H + h) * rec.size;
        if (kOut) {
            for (int i = tid; i < rec.size / 4; i += THREADS) kernel_common::cp_async16(buf + 4 * i, src + 4 * i);
        } else {
            const int nk = rec.cp * MAX_N / 4;
            for (int i = tid; i < nk + MAX_N / 4; i += THREADS) {
                const bool k_part = i < nk;
                kernel_common::cp_async16(buf + (k_part ? 4 * i : sg.ecl + 4 * (i - nk)),
                                          src + (k_part ? rec.kr + 4 * i : rec.ecl + 4 * (i - nk)));
            }
        }
        const int64_t pos0 = (int64_t)(first + ci) * C;
        copy_rows(reinterpret_cast<T*>(buf + sg.v), SLAB, vb + pos0 * st.v[1], st.v[1], C,
                  min(C, d.S - (int)pos0), mw, vvec, tid);
    }
    kernel_common::cp_async_commit();

    const int n0 = 2 * (tid / (SLAB / 2)), c0 = 2 * (tid % (SLAB / 2));  // this thread's state tile
    float s[2][2] = {};
    if (kOut) {
        const float* start = gi == 0 ? s0 + bh * NN : ws_state + ((int64_t)(gi - 1) * d.B * d.H + bh) * NN;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
                if (n0 + i < d.N && c0 + j < mw) s[i][j] = start[(n0 + i) * d.N + ms + c0 + j];
    }
    kernel_common::cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < count * C * SLAB; i += THREADS) {
        const int e = i % (C * SLAB);
        const T* V = reinterpret_cast<const T*>(sm + (i / (C * SLAB)) * sg.size + sg.v);
        VS[i] = e % SLAB < mw ? to_f32(V[e]) : 0.f;
    }
    __syncthreads();

    // pass 1: S ← exp(cum_last) S + k_remᵀ v chunk by chunk, each sum in t order
    float decay = 1.f;  // (a): Π exp(cum_last) of channel tid
    for (int ci = 0; ci < count; ++ci) {
        const float* KR = sm + ci * sg.size + sg.kr;
        const float* ECL = sm + ci * sg.size + sg.ecl;
        const float* VC = VS + ci * C * SLAB;
        if (kOut) {
#pragma unroll
            for (int i = 0; i < 2; ++i)
                *reinterpret_cast<float2*>(SS + (ci * MAX_N + n0 + i) * SLAB + c0) = make_float2(s[i][0], s[i][1]);
        }
        float acc[2][2] = {};
#pragma unroll 4
        for (int t = 0; t < C; ++t) fma2x2(acc, ld2(KR + t * MAX_N + n0), ld2(VC + t * SLAB + c0));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float e = ECL[n0 + i];
#pragma unroll
            for (int j = 0; j < 2; ++j) s[i][j] = e * s[i][j] + acc[i][j];
        }
        if (!kOut && tid < d.N) decay *= ECL[tid];
    }

    if (kOut) {  // pass 2: y = r_dec·S + A·v + diag·v for every chunk at once
        __syncthreads();
        float* yb = y + b * st.y[0] + h * st.y[2] + ms;
        const int per = rec.cp / 2 * (SLAB / 4);  // tiles per chunk
        for (int tile = tid; tile < count * per; tile += THREADS) {
            const int ci = tile / per, t0 = 2 * (tile % per / (SLAB / 4)), m0 = 4 * (tile % (SLAB / 4));
            const int64_t pos0 = (int64_t)(first + ci) * C;
            const int valid = min(C, d.S - (int)pos0);
            if (t0 >= valid || m0 >= mw) continue;
            const float* buf = sm + ci * sg.size;
            const float* RDT = buf + rec.rdt;
            const float* AT = buf + rec.at;
            const float* DG = buf + rec.dg;
            const float* VC = VS + ci * C * SLAB;
            const float* SC = SS + ci * MAX_N * SLAB;
            float yi[2][4] = {}, in[2][4] = {};
#pragma unroll 4
            for (int q = 0; q < d.N; ++q) {
                const float2 x = ld2(RDT + q * ldt + t0);
                const float4 z4 = ld4(SC + q * SLAB + m0);
                const float z[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    yi[0][j] = fmaf(x.x, z[j], yi[0][j]);
                    yi[1][j] = fmaf(x.y, z[j], yi[1][j]);
                }
            }
            for (int jr = 0; jr <= t0; ++jr) {  // row t0 sums jr < t0, row t0 + 1 jr <= t0
                const float2 a = ld2(AT + jr * ldt + t0);
                const float4 v4 = ld4(VC + jr * SLAB + m0);
                const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    if (jr < t0) in[0][j] = fmaf(a.x, vv[j], in[0][j]);
                    in[1][j] = fmaf(a.y, vv[j], in[1][j]);
                }
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int t = t0 + i;
                if (t >= valid) break;
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (m0 + j < mw)
                        yb[(pos0 + t) * st.y[1] + m0 + j] = yi[i][j] + in[i][j] + DG[t] * VC[t * SLAB + m0 + j];
            }
        }
    }

    // the state out: (c) the last group's final state, (a) the local state
    float* out = nullptr;
    if (kOut && gi == d.ng - 1) out = sT + bh * NN;
    if (!kOut) {
        out = ws_state + ((int64_t)gi * d.B * d.H + bh) * NN;
        if (ms == 0 && tid < d.N) ws_decay[((int64_t)gi * d.B * d.H + bh) * d.N + tid] = decay;
    }
    if (out != nullptr) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
                if (n0 + i < d.N && c0 + j < mw) out[(n0 + i) * d.N + ms + c0 + j] = s[i][j];
    }
}

// ------------------------------------------------------------------ (b)
// start_{g+1} = decay_g ∘ start_g + local_g, written over local_g
__global__ void __launch_bounds__(256)
wkv_pass_kernel(const float* __restrict__ s0, float* __restrict__ ws_state, const float* __restrict__ ws_decay,
                Dims d) {
    const int h = blockIdx.y, b = blockIdx.z;
    const int e = blockIdx.x * 256 + threadIdx.x;
    const int64_t NN = (int64_t)d.N * d.N;
    if (e >= NN) return;
    const int64_t bh = (int64_t)b * d.H + h;
    float s = s0[bh * NN + e];
    for (int gi = 0; gi + 1 < d.ng; ++gi) {
        const int64_t slot = (int64_t)gi * d.B * d.H + bh;
        float* p = ws_state + slot * NN + e;
        s = ws_decay[slot * d.N + e / d.N] * s + *p;
        *p = s;
    }
}

// ------------------------------------------------------------- launches
Dims dims(int B, int H, int S, int N, int C, bool vec) {
    Dims d;
    d.B = B, d.H = H, d.S = S, d.N = N, d.C = C;
    d.G = group_chunks(S, C);
    d.nc = (S + C - 1) / C;
    d.ng = (d.nc + d.G - 1) / d.G;
    d.slabs = (N + SLAB - 1) / SLAB;
    d.vec = vec;
    return d;
}

// workspace (floats): the records, then the groups' states, then their decays
size_t records_floats(const Dims& d) { return (size_t)d.B * d.nc * d.H * Record(d.C).size; }
size_t states_floats(const Dims& d) { return (size_t)(d.ng - 1) * d.B * d.H * d.N * d.N; }

template <typename T, bool kOut>
cudaError_t launch_group(const Dims& d, dim3 grid, const T* v, const float* records, const float* s0,
                         float* ws_state, float* ws_decay, float* y, float* sT, const Strides& st,
                         cudaStream_t stream) {
    auto kern = wkv_group_kernel<T, kOut>;
    static kernel_common::SmemGrant grant;
    const size_t bytes = group_smem_bytes(d.C, sizeof(T), d.G, kOut);
    cudaError_t e = grant.ensure(kern, bytes);
    if (e != cudaSuccess) return e;
    kern<<<grid, THREADS, bytes, stream>>>(v, records, s0, ws_state, ws_decay, y, sT, d, st);
    return cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u, const float* s0,
           float* y, float* sT, float* ws, const Dims& d, const Strides& st, cudaStream_t stream) {
    const T *rt = static_cast<const T*>(r), *kt = static_cast<const T*>(k), *vt = static_cast<const T*>(v);
    float* records = ws;
    float* ws_state = records + records_floats(d);
    float* ws_decay = ws_state + states_floats(d);
    auto chunk = wkv_chunk_kernel<T>;
    static kernel_common::SmemGrant grant;
    const size_t bytes = chunk_smem_bytes(d.C, sizeof(T));
    cudaError_t e = grant.ensure(chunk, bytes);
    if (e != cudaSuccess) return (int)e;
    chunk<<<dim3(d.nc, d.H, d.B), THREADS, bytes, stream>>>(rt, kt, w, u, records, d, st);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (d.ng > 1) {
        e = launch_group<T, false>(d, dim3((d.ng - 1) * d.slabs, d.H, d.B), vt, records, s0, ws_state, ws_decay, y,
                                   sT, st, stream);
        if (e != cudaSuccess) return (int)e;
        wkv_pass_kernel<<<dim3((d.N * d.N + 255) / 256, d.H, d.B), 256, 0, stream>>>(s0, ws_state, ws_decay, d);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return (int)launch_group<T, true>(d, dim3(d.ng * d.slabs, d.H, d.B), vt, records, s0, ws_state, ws_decay, y,
                                      sT, st, stream);
}

bool valid(int B, int H, int S, int N, int chunk) {
    return N >= 1 && N <= MAX_N && chunk >= 1 && chunk <= MAX_C && S >= 1 && B >= 1 && H >= 1;
}

}  // namespace

extern "C" {

// f32 workspace: every chunk's record (B, n_chunks, H, record), every
// state group's local, then starting, state but the last's ((n_groups -
// 1), B, H, N, N), then their decays ((n_groups - 1), B, H, N).  The
// caller allocates it.
size_t rwkv6_wkv_workspace_floats(int B, int H, int S, int N, int chunk) {
    if (!valid(B, H, S, N, chunk)) return 0;
    const Dims d = dims(B, H, S, N, chunk, false);
    return records_floats(d) + states_floats(d) + (size_t)(d.ng - 1) * B * H * N;
}

// dtype (of r, k, v): 0 float32, 1 bfloat16.  r, k, v, w, y are indexed
// [b][s][h][n] through strides = {r_b, r_s, r_h, k_b, k_s, k_h, v_b, v_s,
// v_h, w_b, w_s, w_h, y_b, y_s, y_h} (elements; n has unit stride); u is
// (H, N) and state_in / state_out (B, H, N, N), contiguous f32; workspace
// holds rwkv6_wkv_workspace_floats(...) floats.  Needs 1 <= N <= 64,
// 1 <= chunk <= 64, S >= 1.  Up to four kernels, one call.
// Returns the cudaError_t of the launches (0 on success).
int rwkv6_wkv_fwd(int dtype, const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* state_in, void* y, void* state_out, void* workspace,
                  int B, int H, int S, int N, int chunk, const int64_t* strides, void* stream) {
    if (!valid(B, H, S, N, chunk) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
    Strides st;
    for (int i = 0; i < 3; ++i) {
        st.r[i] = strides[i];
        st.k[i] = strides[3 + i];
        st.v[i] = strides[6 + i];
        st.w[i] = strides[9 + i];
        st.y[i] = strides[12 + i];
    }
    // cp.async takes 16-byte rows: aligned bases and strides, N a multiple of 16 bytes
    const int tb = dtype == 1 ? 2 : 4;
    bool vec = (N * tb) % 16 == 0;
    for (const void* p : {r, k, v, w}) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    for (int i = 0; i < 3; ++i)
        vec = vec && (st.r[i] * tb) % 16 == 0 && (st.k[i] * tb) % 16 == 0 && (st.v[i] * tb) % 16 == 0 &&
              (st.w[i] * 4) % 16 == 0;
    const Dims d = dims(B, H, S, N, chunk, vec);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* wf = static_cast<const float*>(w);
    const float* uf = static_cast<const float*>(u);
    const float* s0 = static_cast<const float*>(state_in);
    float* yf = static_cast<float*>(y);
    float* sT = static_cast<float*>(state_out);
    float* ws = static_cast<float*>(workspace);
    if (dtype == 0) return launch<float>(r, k, v, wf, uf, s0, yf, sT, ws, d, st, s);
    return launch<__nv_bfloat16>(r, k, v, wf, uf, s0, yf, sT, ws, d, st, s);
}

// What the entry point runs for a dtype and shape, as chip_smoke.py prints
// it: the product units, the chunks per state group, and the blocks of
// each kernel ((i), (a), (b), (c)).
const char* rwkv6_wkv_plan(int dtype, int B, int H, int S, int N, int chunk) {
    static thread_local char buf[192];
    if (!valid(B, H, S, N, chunk) || (dtype != 0 && dtype != 1)) return "invalid";
    const Dims d = dims(B, H, S, N, chunk, false);
    const int per_group = d.slabs * H * B;
    snprintf(buf, sizeof buf, "fma(register_tiles,sequential_sums) group_chunks=%d groups=%d blocks=%d+%d+%d+%d",
             d.G, d.ng, d.nc * H * B, (d.ng - 1) * per_group, d.ng > 1 ? ((N * N + 255) / 256) * H * B : 0,
             d.ng * per_group);
    return buf;
}

const char* rwkv6_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
