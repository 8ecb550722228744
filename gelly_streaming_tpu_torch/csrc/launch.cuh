// The launch plumbing every kernel library of this package shares: the card a
// launcher runs on, the size of a cooperative grid there, and the text of a
// refused launch's error code. Each csrc/*.cu includes it once and is built
// into a library of its own (ops/cuda_build.py), so each library has one copy.
//
// The CUDA runtime linked into a library keeps its own current device: a
// launcher selects the operands' card first, whatever PyTorch's is. The grid
// helpers read the card once and keep what they read, so that a launch makes
// no occupancy or attribute query after the first on its card.

#pragma once

#include <atomic>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

// cards a library keeps per-card values for
constexpr int kMaxDevices = 64;

// Make `device` the current card of the runtime linked into this library.
inline cudaError_t select_device(int device) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return e;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

// The streaming multiprocessors of each card, read once a card: 0 until then.
std::atomic<int> g_sms[kMaxDevices];

// The streaming multiprocessors of `device`, into *out.
inline cudaError_t sm_count(int device, int* out) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int sms = g_sms[device].load(std::memory_order_relaxed);
  if (sms == 0) {
    const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    g_sms[device].store(sms, std::memory_order_relaxed);
  }
  *out = sms;
  return cudaSuccess;
}

// The most blocks of `kernel` (`threads` a block, `smem` bytes of dynamic
// shared memory) resident on `device` at once, blocks an SM times SMs, into
// *out: a cooperative grid's bound. `cache` (kMaxDevices entries, 0 until
// read) keeps the result per card, so that later launches read it back; a
// kernel whose shared memory varies from launch to launch passes nullptr and
// asks each time.
inline cudaError_t cooperative_blocks(const void* kernel, int threads, size_t smem, int device,
                                      std::atomic<int>* cache, int* out) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int blocks = cache != nullptr ? cache[device].load(std::memory_order_relaxed) : 0;
  if (blocks == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return e;
    e = sm_count(device, &sms);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    blocks = per_sm * sms;
    if (cache != nullptr) cache[device].store(blocks, std::memory_order_relaxed);
  }
  *out = blocks;
  return cudaSuccess;
}

}  // namespace

// The text of an error code that a launcher of this library returned.
extern "C" const char* launch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
