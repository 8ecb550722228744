// fused_sage_matmul: out = act(h @ w_self + agg @ w_nbr + b) for Hopper (sm_90a).
//
// Replaces gelly_streaming_tpu/ops/pallas_kernels.py:fused_sage_matmul, the
// Pallas TPU kernel that keeps one [tile_v, tile_o] accumulator across both
// contractions of a GraphSAGE layer and writes each output tile once.
//
// Shapes: h, agg [V, F]; w_self, w_nbr [F, O]; b [O]; out [V, O]; all
// row-major and contiguous, all of one type (float or __nv_bfloat16). Any V,
// F and O: the ragged edge is masked here, nothing is padded by the caller.
// act is relu or the identity.
//
// Design. One block of 256 threads owns a 64 x 64 output tile and keeps it in
// f32 registers, a 4 x 4 block per thread (rows ty + 16 i, columns tx + 16 j,
// so that a warp's shared-memory reads and global stores touch neighbouring
// addresses). The block walks F in 16-deep shared-memory tiles, first over
// h . w_self and then over agg . w_nbr, into the same accumulator; the tiles
// are converted to f32 as they are staged. The epilogue adds the bias in f32,
// applies relu if asked, rounds once to the output type (__float2bfloat16,
// round to nearest even) and stores each output element once. The [V, O]
// partial products never reach device memory, which is the point of the
// fusion.
//
// What bounds it. At the streaming GraphSAGE configuration (V = 65,536,
// [128 -> 256] then [256 -> 128], bf16) a layer does about 128 operations per
// byte it must move, under the H100's ~295 operations per byte in bf16, so the
// least time is set by device memory: 67.2 MB and 83.9 MB, about 20 us and
// 25 us at 3.35 TB/s, 45 us a window.
//
// What this simple design leaves on the table. The products run on the CUDA
// cores in f32 FMA (67 TFLOP/s peak) rather than on the tensor cores
// (989 TFLOP/s in bf16), so the kernel is bound by arithmetic and shared-memory
// traffic rather than by device memory. Tiles are staged by plain loads with
// a barrier per 16-deep step and no double buffering, so loads do not overlap
// the FMAs. A later version would stage tiles with TMA into a ring of shared
// buffers under mbarriers and run wgmma over 64-row tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTileV = 64;   // output rows per block
constexpr int kTileO = 64;   // output columns per block
constexpr int kTileF = 16;   // contraction depth per shared-memory step
constexpr int kThreads = 256;
constexpr int kSide = 16;    // threads per side of the 16 x 16 thread grid
constexpr int kPer = 4;      // outputs per thread per side

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Accumulates x[row0:row0+64, :F] @ w[:F, col0:col0+64] into acc.
template <typename T>
__device__ __forceinline__ void accumulate(
    const T* __restrict__ x, const T* __restrict__ w, int V, int F, int O,
    int row0, int col0, float (*xs)[kTileV + 1], float (*ws)[kTileO],
    float acc[kPer][kPer]) {
  const int t = threadIdx.x;
  const int tx = t % kSide;
  const int ty = t / kSide;
  for (int f0 = 0; f0 < F; f0 += kTileF) {
    // x tile [64 rows, 16 deep]: neighbouring threads read neighbouring
    // columns of one row; stored transposed, padded against bank conflicts.
#pragma unroll
    for (int i = 0; i < (kTileV * kTileF) / kThreads; ++i) {
      const int r = t / kTileF + i * (kThreads / kTileF);
      const int k = t % kTileF;
      const int gr = row0 + r;
      const int gk = f0 + k;
      xs[k][r] = (gr < V && gk < F) ? to_f32(x[(size_t)gr * F + gk]) : 0.0f;
    }
    // w tile [16 deep, 64 columns]: neighbouring threads, neighbouring columns.
#pragma unroll
    for (int i = 0; i < (kTileF * kTileO) / kThreads; ++i) {
      const int k = t / kTileO + i * (kThreads / kTileO);
      const int c = t % kTileO;
      const int gk = f0 + k;
      const int gc = col0 + c;
      ws[k][c] = (gk < F && gc < O) ? to_f32(w[(size_t)gk * O + gc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileF; ++k) {
      float a[kPer], b[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) a[i] = xs[k][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kPer; ++j) b[j] = ws[k][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_sage_matmul_kernel(
    const T* __restrict__ h, const T* __restrict__ agg,
    const T* __restrict__ w_self, const T* __restrict__ w_nbr,
    const T* __restrict__ b, T* __restrict__ out, int V, int F, int O, int relu) {
  __shared__ float xs[kTileF][kTileV + 1];
  __shared__ float ws[kTileF][kTileO];
  const int row0 = blockIdx.x * kTileV;
  const int col0 = blockIdx.y * kTileO;
  float acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.0f;

  accumulate<T>(h, w_self, V, F, O, row0, col0, xs, ws, acc);
  accumulate<T>(agg, w_nbr, V, F, O, row0, col0, xs, ws, acc);

  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = col0 + tx + kSide * j;
    if (c >= O) continue;
    const float bias = to_f32(b[c]);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = row0 + ty + kSide * i;
      if (r >= V) continue;
      float v = acc[i][j] + bias;
      if (relu) v = fmaxf(v, 0.0f);
      out[(size_t)r * O + c] = from_f32<T>(v);
    }
  }
}

template <typename T>
void launch(const void* h, const void* agg, const void* w_self, const void* w_nbr,
            const void* b, void* out, int V, int F, int O, int relu,
            cudaStream_t stream) {
  const dim3 grid((V + kTileV - 1) / kTileV, (O + kTileO - 1) / kTileO);
  fused_sage_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(agg),
      static_cast<const T*>(w_self), static_cast<const T*>(w_nbr),
      static_cast<const T*>(b), static_cast<T*>(out), V, F, O, relu);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 when it was accepted). V and O must be positive.
extern "C" int fused_sage_matmul_launch(
    const void* h, const void* agg, const void* w_self, const void* w_nbr,
    const void* b, void* out, int V, int F, int O, int dtype, int relu,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(h, agg, w_self, w_nbr, b, out, V, F, O, relu, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(h, agg, w_self, w_nbr, b, out, V, F, O, relu, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_sage_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
