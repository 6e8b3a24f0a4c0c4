// What the conv kernels (conv2d_fwd.cu, conv2d_wgrad.cu) share: the bf16 tensor-core product and
// the split plan that sizes a launch to one wave of resident blocks. Each source includes it into
// its own translation unit; everything here has internal linkage (an anonymous namespace), so no
// kernel or host symbol crosses between the objects of the library.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
// a split keeps at least this many BK stages of the reduction
constexpr int MIN_STAGES_PER_SPLIT = 4;
constexpr int MAX_DEVICES = 64;

// c += a * b for one m16n8k16 tile on the tensor cores: bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Blocks of one wave on the current device for `kernel` at `threads` threads and `smem` bytes of
// dynamic shared memory: SMs x its resident blocks per SM (registers and shared memory
// permitting), from the occupancy calculator; cached per device in `cache` (one array of
// MAX_DEVICES per kernel; every writer stores the same value).
template <typename Kernel>
cudaError_t wave_slots(Kernel kernel, std::atomic<int>* cache, int* slots, int threads = THREADS,
                       int smem = 0) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES) {
    const int cached = cache[dev].load(std::memory_order_relaxed);
    if (cached > 0) {
      *slots = cached;
      return cudaSuccess;
    }
  }
  int blocks = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *slots = sms * (blocks > 1 ? blocks : 1);
  if (dev < MAX_DEVICES) cache[dev].store(*slots, std::memory_order_relaxed);
  return cudaSuccess;
}

// Slices of a reduction of `stages` BK stages for a launch of `blocks` output tiles: as many as
// fit the tiles into one wave of `slots` resident blocks, never past it (a second, partial wave
// costs a whole wave), keeping at least MIN_STAGES_PER_SPLIT stages in each slice and at most
// `max_splits` slices. 1 means no split.
inline int plan_splits(int slots, long long blocks, long long stages, int max_splits) {
  long long s = slots / blocks;
  if (s > stages / MIN_STAGES_PER_SPLIT) s = stages / MIN_STAGES_PER_SPLIT;
  if (s > max_splits) s = max_splits;
  return s > 1 ? (int)s : 1;
}

}  // namespace
