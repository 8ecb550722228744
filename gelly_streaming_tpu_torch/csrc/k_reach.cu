// One hop of the k >= 3 spanner's k-hop search, for Hopper (sm_90a).
//
// Replaces gelly_streaming_tpu/library/spanner.py:_k_reach_cnt (:103), an XLA
// step of the JAX package: there each hop gathers every spanner entry's
// source words, and ORs each target's run of them with a segmented
// associative_scan over the entries sorted by target. Here the entries come
// sorted by target once a window (row_ptr, src: a CSR by target, built with
// torch by ops/reach_kernels.py:target_csr) and one launch is one hop:
//
//     out[t, w] = in[t, w] | OR over e in [row_ptr[t], row_ptr[t + 1]) of in[src[e], w]
//
// for every target t < V and word w < W. Query i of the batch owns bit i % 32
// of word i / 32. The frontier is vertex-major, [V, W] int32 words, so one
// vertex's W words are one contiguous row, and the lanes that read a source's
// row read neighbouring addresses (W = 32: one 128-byte line a source). in
// and out are distinct buffers: a hop reads only the frontier it starts from,
// so no query travels two edges in one hop.
//
// What bounds it: each hop reads 2S source rows of W words (2S the directed
// entries) and writes V rows. The frontier (V x W x 4 bytes: 32 MB at V = 2^18,
// W = 32) fits in the 50 MB L2, so the source rows are mostly L2 hits, and a
// hop is bound by L2 traffic and by the latency of its dependent loads
// (src[e], then the row it names), not by device memory. The design for that:
// a group of g lanes a target (g the least power of two >= min(W, 32)), 32 / g
// targets a warp, each lane a word (striding by g when W > 32), and the edge
// loop unrolled four times so that four source rows are in flight a lane. A
// target with far more entries than the rest serializes in its group; the
// cells this runs at have in-degrees in the tens.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
k_reach_hop(const int* __restrict__ row_ptr, const int* __restrict__ src,
            const int* __restrict__ in, int* __restrict__ out, int V, int W,
            int g_log2) {
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long t = gid >> g_log2;
  if (t >= V) return;
  const int g = 1 << g_log2;
  const int lane = static_cast<int>(gid & (g - 1));
  const int begin = __ldg(row_ptr + t);
  const int end = __ldg(row_ptr + t + 1);
  const size_t words = static_cast<size_t>(W);
  for (int w = lane; w < W; w += g) {
    int acc = __ldg(in + t * words + w);
    int e = begin;
    for (; e + 4 <= end; e += 4) {
      const size_t s0 = static_cast<size_t>(__ldg(src + e));
      const size_t s1 = static_cast<size_t>(__ldg(src + e + 1));
      const size_t s2 = static_cast<size_t>(__ldg(src + e + 2));
      const size_t s3 = static_cast<size_t>(__ldg(src + e + 3));
      acc |= __ldg(in + s0 * words + w) | __ldg(in + s1 * words + w) |
             __ldg(in + s2 * words + w) | __ldg(in + s3 * words + w);
    }
    for (; e < end; ++e) {
      acc |= __ldg(in + static_cast<size_t>(__ldg(src + e)) * words + w);
    }
    out[t * words + w] = acc;
  }
}

// The CUDA runtime linked into this library keeps its own current device:
// the launcher selects the operands' card first, whatever PyTorch's is.
cudaError_t select_device(int device) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return e;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

}  // namespace

// One hop, in -> out, on `stream` of card `device`. row_ptr: [V + 1] int32;
// src: the sources in target order (int32, at least row_ptr[V] of them); in,
// out: [V, W] int32, distinct. Returns cudaGetLastError() after the launch (0
// when it was accepted).
extern "C" int k_reach_hop_launch(const void* row_ptr, const void* src,
                                  const void* in, void* out, int V, int W,
                                  int device, void* stream) {
  if (V <= 0 || W <= 0 || device < 0 || in == out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t d = select_device(device);
  if (d != cudaSuccess) return static_cast<int>(d);
  int g_log2 = 0;
  while ((1 << g_log2) < W && g_log2 < 5) ++g_log2;
  const long long threads = static_cast<long long>(V) << g_log2;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  k_reach_hop<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(src),
      static_cast<const int*>(in), static_cast<int*>(out), V, W, g_log2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* k_reach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
