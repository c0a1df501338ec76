// Helpers shared by every kernel source under kernels/*/csrc/.
//
// _build.py passes this directory to nvcc with -I and hashes this file
// with each source, so an edit here rebuilds every kernel.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace kernel_common {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }
template <> __device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// 16-byte asynchronous copy from device to shared memory (cp.async, L2
// only); ``bytes`` 0 writes 16 zero bytes and reads nothing, though ``src``
// must still be a valid address.  Both addresses on 16 bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes = 16) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// The dynamic shared-memory limit one kernel instantiation has been granted
// on each device.  ``ensure`` raises it only when a launch needs more than
// was granted before, so the driver call is made once per device and size,
// not on every launch; the grant only grows, even under concurrent launches.
// Keep exactly one per kernel function, as a static beside its launch: two
// grants for one function would not see each other's.
class SmemGrant {
  public:
    template <typename Kernel>
    cudaError_t ensure(Kernel kern, size_t bytes) {
        // up to 48 KB needs no grant; setting one that small would lower
        // the limit below the default for every other launch of ``kern``
        if (bytes <= DEFAULT_LIMIT) return cudaSuccess;
        int dev = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e != cudaSuccess) return e;
        if (dev >= MAX_DEVICES)  // not cached: raise on every launch
            return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (granted_[dev].load(std::memory_order_acquire) >= bytes) return cudaSuccess;
        std::lock_guard<std::mutex> hold(raising_);
        if (granted_[dev].load(std::memory_order_relaxed) < bytes) {
            e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
            if (e != cudaSuccess) return e;
            granted_[dev].store(bytes, std::memory_order_release);
        }
        return cudaSuccess;
    }

  private:
    static constexpr int MAX_DEVICES = 64;  // devices whose grant is cached
    static constexpr size_t DEFAULT_LIMIT = 48 * 1024;
    std::atomic<size_t> granted_[MAX_DEVICES] = {};
    std::mutex raising_;
};

}  // namespace kernel_common
