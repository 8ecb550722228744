// The GraphSAGE neighbour mean over a destination-sorted CSR, for Hopper
// (sm_90a): one launch a layer, no atomics, nothing read back to the host.
//
// Replaces, on one card, the mean of gelly_streaming_tpu/models/graphsage.py
// (mean_aggregate, :53): an XLA gather of h[src] and scatter-add into dst in
// the JAX package, not a Pallas kernel. The port's torch form of it
// (models/graphsage.py:mean_aggregate) reads a float32 copy of h, writes
// every message as a float32 row, reads it back and adds it into its
// destination with a float32 atomic a column: at least 16 F bytes of traffic
// a message, and on a skewed stream hundreds of thousands of atomics on the
// same row.
//
// What it computes. row_ptr (int64 [n_rows + 1]) cuts src (int32, the
// messages' sources sorted by destination) into rows: row v holds the
// messages [row_ptr[v], row_ptr[v + 1]). For every row v and column c < f:
//   out[v, c] = T_rn(__fdiv_rn(sum_i float(h[src[i], c]), float(max(cnt, 1))))
// with cnt = row_ptr[v + 1] - row_ptr[v] and T_rn the round to nearest even
// into T (bfloat16 or float32, the dtypes of fused_sage_matmul): the arithmetic of
// (agg / clamp_min(cnt, 1).to(float32)).to(T) in the torch form, with sums
// in float32 registers. A row with no message is zeros. Only the order of a
// row's sum differs from a sequential one; it is fixed by the shapes, so two
// launches give the same bits.
//
// The launch, on a persistent cooperative grid, in two phases split by one
// grid barrier:
//
// 1. Work split by merge path (Merrill and Garland, SC 2016): the n_rows row
//    ends and the n_msgs messages merge into one path of n_rows + n_msgs
//    items, and each worker (a group of g lanes, g a power of two, each lane
//    8 bf16 columns or 4 f32 ones, 16 bytes) takes an equal run of
//    it, found by a binary search of its two diagonals. A hub's messages
//    spread over as many workers as its length asks for, and empty rows cost
//    one store each. A worker walks its messages U at a time: it loads U
//    source ids (each lane the same address, so one transaction a group),
//    then U rows of h with 16-byte loads, all in flight before the first
//    add, then adds them in order, storing each row whose end it passes.
//    A row that began before the worker's run (its head) or goes on after
//    it (its tail) is stored as a float32 partial in the scratch instead,
//    with its id.
// 2. Fix-up: each worker whose run ends a row that began earlier adds the
//    tails of the workers before it that hold the same row, in worker order,
//    then its own head, and stores the mean.
//
// What bounds it on this card. Each message reads its 4-byte source id and
// the source's row (2 F bytes in bfloat16), and each row writes 2 F bytes:
// E (4 + 2 F) + 2 V F bytes. At the benchmark's last window (E = 123,718,280,
// V = 2^21, F = 256) that is 64.9 GB, 19.4 ms at 3.35 TB/s, less where
// popular sources' rows stay in the 50 MB L2. The gathers are random 2F-byte
// rows, bound by how many are in flight: each lane keeps kUnroll 16-byte
// loads outstanding, and the register cap of kMinBlocks blocks an SM keeps
// 1024 threads on each. On an H100 that beat 8 loads at 512 threads an SM
// (112 registers) by 1.5x at F = 104 and 256; 16 loads, or 8 under the cap
// (spilled), were slower.

#include <atomic>
#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// messages a worker loads before it adds the first of them
constexpr int kUnroll = 4;
// the least path items a worker takes, so a small input uses few blocks
constexpr long long kMinItems = 64;
// blocks an SM the register budget must allow: 1024 threads, 64 registers
constexpr int kMinBlocks = 4;

struct MeanArgs {
  const void* h;
  const int* src;
  const long long* row_ptr;
  void* out;
  float* head_part;  // [workers, f]
  float* tail_part;  // [workers, f]
  int* head_row;     // [workers]
  int* tail_row;     // [workers]
  long long n_msgs;
  long long per;     // path items a worker
  int n_rows;
  int f;
  int log2g;         // lanes a worker: 1 << log2g
  int vec_lanes;     // 16-byte lanes a row: f / (16 / sizeof(T))
  int workers;
};

// 16 bytes of T as float32 and back, round to nearest even.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void add(float* acc, const uint4& v) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[2 * k] += __uint_as_float(w[k] << 16);
      acc[2 * k + 1] += __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float* x) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * k]));
      const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * k + 1]));
      w[k] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void add(float* acc, const uint4& v) {
    acc[0] += __uint_as_float(v.x);
    acc[1] += __uint_as_float(v.y);
    acc[2] += __uint_as_float(v.z);
    acc[3] += __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                      __float_as_uint(x[3]));
  }
};

// The merge path's split at diagonal d: (rows ended, messages taken) with
// rows + messages = d. A row's end comes before message j when the row ends
// at or before j.
__device__ __forceinline__ void path_split(const long long* row_ptr, long long d,
                                           long long n_msgs, int n_rows, long long* rows,
                                           long long* msgs) {
  long long lo = d - n_msgs > 0 ? d - n_msgs : 0;
  long long hi = d < n_rows ? d : n_rows;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(row_ptr + mid + 1) <= d - mid - 1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  *rows = lo;
  *msgs = d - lo;
}

// Row `row`'s mean, from its float32 sum and its message count, into out.
template <typename T>
__device__ __forceinline__ void store_mean(const MeanArgs& a, long long row, long long col,
                                           const float* sum, long long cnt) {
  constexpr int N = Vec<T>::kN;
  const float c = static_cast<float>(cnt > 1 ? cnt : 1);
  float q[N];
#pragma unroll
  for (int k = 0; k < N; ++k) q[k] = __fdiv_rn(sum[k], c);
  T* out = static_cast<T*>(a.out) + row * a.f + col;
  *reinterpret_cast<uint4*>(out) = Vec<T>::pack(q);
}

__device__ __forceinline__ void store_part(float* part, const float* sum, int n) {
  for (int k = 0; k < n; k += 4) {
    *reinterpret_cast<float4*>(part + k) = make_float4(sum[k], sum[k + 1], sum[k + 2], sum[k + 3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) sage_segment_mean(MeanArgs a) {
  constexpr int N = Vec<T>::kN;
  cg::grid_group grid = cg::this_grid();
  const int g = 1 << a.log2g;
  const int lane = threadIdx.x & (g - 1);
  const long long worker = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> a.log2g;
  const long long total = a.n_rows + a.n_msgs;
  const T* h = static_cast<const T*>(a.h);
  const long long* row_ptr = a.row_ptr;

  // ---- 1. each worker's run of the merge path
  if (worker < a.workers) {
    const long long d0 = worker * a.per < total ? worker * a.per : total;
    const long long d1 = d0 + a.per < total ? d0 + a.per : total;
    long long i0, j0, i1, j1;
    path_split(row_ptr, d0, a.n_msgs, a.n_rows, &i0, &j0);
    path_split(row_ptr, d1, a.n_msgs, a.n_rows, &i1, &j1);
    const long long first_start = i0 < a.n_rows ? __ldg(row_ptr + i0) : a.n_msgs;
    const bool head = i0 < i1 && first_start < j0;
    const long long tail_start = i1 < a.n_rows ? __ldg(row_ptr + i1) : a.n_msgs;
    const bool tail = i1 < a.n_rows && j1 > (tail_start > j0 ? tail_start : j0);

    for (int vl = lane; vl - lane < a.vec_lanes; vl += g) {
      const bool active = vl < a.vec_lanes;
      const long long col = static_cast<long long>(vl) * N;
      float acc[N];
#pragma unroll
      for (int k = 0; k < N; ++k) acc[k] = 0.f;
      long long i = i0, j = j0;
      long long row_start = first_start;
      long long row_end = i < i1 ? __ldg(row_ptr + i + 1) : j1;
      while (j < j1) {
        const int n = j1 - j < kUnroll ? static_cast<int>(j1 - j) : kUnroll;
        int s[kUnroll];
        uint4 v[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (k < n) {
            s[k] = __ldg(a.src + j + k);
            if (static_cast<unsigned>(s[k]) >= static_cast<unsigned>(a.n_rows)) __trap();
          }
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (k < n && active) {
            v[k] = __ldg(reinterpret_cast<const uint4*>(h + static_cast<long long>(s[k]) * a.f + col));
          }
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (k < n) {
            while (j + k >= row_end) {  // rows that end before message j + k
              if (active) {
                if (i == i0 && head) {
                  store_part(a.head_part + worker * a.f + col, acc, N);
                } else {
                  store_mean<T>(a, i, col, acc, row_end - row_start);
                }
              }
#pragma unroll
              for (int q = 0; q < N; ++q) acc[q] = 0.f;
              row_start = row_end;
              ++i;
              row_end = i < i1 ? __ldg(row_ptr + i + 1) : j1;
            }
            if (active) Vec<T>::add(acc, v[k]);
          }
        }
        j += n;
      }
      while (i < i1) {  // rows that end after the run's last message
        if (active) {
          if (i == i0 && head) {
            store_part(a.head_part + worker * a.f + col, acc, N);
          } else {
            store_mean<T>(a, i, col, acc, row_end - row_start);
          }
        }
#pragma unroll
        for (int q = 0; q < N; ++q) acc[q] = 0.f;
        row_start = row_end;
        ++i;
        row_end = i < i1 ? __ldg(row_ptr + i + 1) : j1;
      }
      if (tail && active) store_part(a.tail_part + worker * a.f + col, acc, N);
    }
    if (lane == 0) {
      a.head_row[worker] = head ? static_cast<int>(i0) : -1;
      a.tail_row[worker] = tail ? static_cast<int>(i1) : -1;
    }
  }
  grid.sync();

  // ---- 2. rows cut by a run's end: the partials in worker order
  if (worker < a.workers) {
    const int r = __ldcg(a.head_row + worker);
    if (r >= 0) {
      long long first = worker;
      while (first > 0 && __ldcg(a.tail_row + first - 1) == r) --first;
      const long long cnt = __ldg(row_ptr + r + 1) - __ldg(row_ptr + r);
      for (int vl = lane; vl < a.vec_lanes; vl += g) {
        const long long col = static_cast<long long>(vl) * N;
        float acc[N];
#pragma unroll
        for (int k = 0; k < N; ++k) acc[k] = 0.f;
        for (long long w = first; w <= worker; ++w) {
          const float* part = (w < worker ? a.tail_part : a.head_part) + w * a.f + col;
#pragma unroll
          for (int k = 0; k < N; k += 4) {
            const float4 x = __ldcg(reinterpret_cast<const float4*>(part + k));
            acc[k] += x.x;
            acc[k + 1] += x.y;
            acc[k + 2] += x.z;
            acc[k + 3] += x.w;
          }
        }
        store_mean<T>(a, r, col, acc, cnt);
      }
    }
  }
}

// ---------------------------------------------------------------- launching
// dtype codes of the C interface: 0 bfloat16, 1 float32
constexpr int kDtypes = 2;
// the most blocks of the cooperative grid on each card, by dtype: 0 until read
std::atomic<int> g_max_blocks[kDtypes][kMaxDevices];

const void* kernel_of(int dtype) {
  switch (dtype) {
    case 0: return reinterpret_cast<const void*>(sage_segment_mean<__nv_bfloat16>);
    default: return reinterpret_cast<const void*>(sage_segment_mean<float>);
  }
}

int elem_bytes(int dtype) { return dtype == 1 ? 4 : 2; }

// lanes a worker: the least power of two that covers a row's 16-byte lanes,
// at most a warp
int log2_lanes(int vec_lanes) {
  int log2g = 0;
  while ((1 << log2g) < vec_lanes && log2g < 5) ++log2g;
  return log2g;
}

bool valid(int dtype, int f, int n_rows, int device) {
  return dtype >= 0 && dtype < kDtypes && f > 0 && f % 8 == 0 && n_rows >= 1 && device >= 0;
}

}  // namespace

// The most workers a launch of this dtype and width can take on card
// `device` (the scratch's first dimension), or a negative CUDA error code.
extern "C" long long sage_segment_mean_max_workers(int dtype, int f, int device) {
  if (!valid(dtype, f, 1, device)) return -static_cast<long long>(cudaErrorInvalidValue);
  cudaError_t e = select_device(device);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  int most = 0;
  e = cooperative_blocks(kernel_of(dtype), kThreads, 0, device, g_max_blocks[dtype], &most);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  const int vec_lanes = f * elem_bytes(dtype) / 16;
  return static_cast<long long>(most) * (kThreads >> log2_lanes(vec_lanes));
}

// The mean of every row on `stream` of card `device`. h: [n_rows, f] of the
// dtype, 16-byte aligned; src: [n_msgs] int32, every id below n_rows;
// row_ptr: [n_rows + 1] int64, row_ptr[0] = 0, nondecreasing, row_ptr[n_rows]
// = n_msgs; out: [n_rows, f] of the dtype, 16-byte aligned, distinct from h;
// parts: [2, capacity, f] float32; rows: [2, capacity] int32, capacity at
// least sage_segment_mean_max_workers. Returns the launch's error code (0
// when it was accepted).
extern "C" int sage_segment_mean_launch(const void* h, const void* src, const void* row_ptr,
                                        void* out, void* parts, void* rows, long long capacity,
                                        long long n_msgs, int n_rows, int f, int dtype,
                                        int device, void* stream) {
  if (!valid(dtype, f, n_rows, device) || n_msgs < 0 || n_msgs > INT_MAX || capacity < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = select_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int most = 0;
  e = cooperative_blocks(kernel_of(dtype), kThreads, 0, device, g_max_blocks[dtype], &most);
  if (e != cudaSuccess) return static_cast<int>(e);
  MeanArgs a;
  a.h = h;
  a.src = static_cast<const int*>(src);
  a.row_ptr = static_cast<const long long*>(row_ptr);
  a.out = out;
  a.n_msgs = n_msgs;
  a.n_rows = n_rows;
  a.f = f;
  a.vec_lanes = f * elem_bytes(dtype) / 16;
  a.log2g = log2_lanes(a.vec_lanes);
  const long long per_block = kThreads >> a.log2g;
  const long long total = static_cast<long long>(n_rows) + n_msgs;
  const long long need = (total + kMinItems * per_block - 1) / (kMinItems * per_block);
  const int blocks = static_cast<int>(need < most ? need : most);
  const long long workers = blocks * per_block;
  if (workers > capacity) return static_cast<int>(cudaErrorInvalidValue);
  a.workers = static_cast<int>(workers);
  a.per = (total + workers - 1) / workers;
  float* part = static_cast<float*>(parts);
  a.head_part = part;
  a.tail_part = part + capacity * f;
  a.head_row = static_cast<int*>(rows);
  a.tail_row = static_cast<int*>(rows) + capacity;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel_of(dtype), dim3(blocks), dim3(kThreads), params, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
