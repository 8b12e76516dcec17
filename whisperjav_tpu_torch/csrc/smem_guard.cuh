// The per-device guard of cudaFuncSetAttribute, shared by the kernels'
// sources. Each source that includes it keeps its own guards and lock.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

namespace {

// cudaFuncSetAttribute acts on the current device's context, so every card
// needs its own call. A guard keeps, per device, the largest dynamic shared
// memory allowed so far and raises it under one lock: host threads driving
// several cards, or two streams of one card, launch safely together.
constexpr int kMaxDevices = 64;

struct SmemGuard {
  std::atomic<int> allowed[kMaxDevices];
};

std::mutex g_smem_mutex;

template <typename Kernel>
int allow_smem(Kernel kernel, SmemGuard& guard, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (guard.allowed[dev].load(std::memory_order_acquire) >= bytes) return 0;
  std::lock_guard<std::mutex> lock(g_smem_mutex);
  if (guard.allowed[dev].load(std::memory_order_relaxed) >= bytes) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  guard.allowed[dev].store(bytes, std::memory_order_release);
  return 0;
}

}  // namespace
