// fused_sage_matmul: out = act(h @ w_self + agg @ w_nbr + b) for Hopper (sm_90a).
//
// Replaces gelly_streaming_tpu/ops/pallas_kernels.py:fused_sage_matmul, the
// Pallas TPU kernel that keeps one [tile_v, tile_o] accumulator across both
// contractions of a GraphSAGE layer and writes each output tile once.
//
// Shapes: h, agg [V, F]; w_self, w_nbr [F, O]; b [O]; out [V, O]; all
// row-major and contiguous, all of one type (float or __nv_bfloat16). act is
// relu or the identity. Two kernels compute it; the caller picks one by a rule
// on the operands (ops/sage_kernels.py:_variant) before it launches:
//
// - "tc", fused_sage_matmul_tc_launch: the tensor-core kernel, for bf16 with
//   F and O multiples of 8 and every operand 16-byte aligned (TMA's rules).
// - "simt", fused_sage_matmul_launch: the CUDA-core kernel, for everything
//   else (float32, any V, F and O, any alignment).
//
// What bounds it. At the streaming GraphSAGE configuration (V = 65,536,
// [128 -> 256] then [256 -> 128], bf16) a layer does about 128 operations per
// byte it must move, under the H100's ~295 operations per byte in bf16, so the
// least time is set by device memory: 67.2 MB and 83.9 MB, about 20 us and
// 25 us at 3.35 TB/s, 45 us a window.
//
// The tensor-core kernel ("tc"). A persistent grid of at most one block per
// SM walks 128-row output tiles (the BN-wide column tiles of one row tile
// next to each other, so a second read of its rows hits L2). In a block, one
// thread of warpgroup 0 issues TMA loads into a ring of shared-memory stages,
// each a 128 x 64 slice of h or agg and the matching 64 x BN slice of w_self
// or w_nbr, both with 128-byte swizzle; a stage is full when its bytes have
// landed on its mbarrier. Warpgroups 1 and 2 each own 64 of the tile's rows
// and run wgmma (m64 nBN k16, bf16 in, f32 accumulate in registers) over the
// concatenated contraction, first h . w_self then agg . w_nbr, into one
// accumulator, keeping one step's products in flight while the next is
// issued, and free a stage on a second mbarrier once its products are done.
// h and agg are K-major A operands as they lie; the weights are read as
// MN-major B operands (wgmma's transpose-B), so no operand is copied or laid
// out anew. The weights (128 KB a layer at the streaming GraphSAGE shapes)
// stay in L2 and are read again for every tile, so device memory sees each
// input byte once. TMA fills zeros beyond V and F. The epilogue adds the
// bias in f32 (loaded before the products, so its latency hides behind
// them), applies relu if asked, rounds once to bf16, transposes within each
// quad of lanes so that every lane holds 8 neighbouring columns, and stores
// each output element once, 16 bytes at a time, masked at V and O. The [V, O]
// partial products never reach device memory. While the multiplying
// warpgroups store one tile, the loader is already filling the ring with
// the next tile's slices.
//
// The CUDA-core kernel ("simt"). One block of 256 threads owns a 64 x 64
// output tile and keeps it in f32 registers, a 4 x 4 block per thread (rows
// ty + 16 i, columns tx + 16 j, so that a warp's shared-memory reads and
// global stores touch neighbouring addresses). The block walks F in 16-deep
// shared-memory tiles, first over h . w_self and then over agg . w_nbr, into
// the same accumulator; the tiles are converted to f32 as they are staged.
// The ragged edge is masked in the loads and the store. The epilogue adds
// the bias in f32, applies relu if asked and rounds once to the output type
// (__float2bfloat16, to nearest even). Its products run in
// f32 FMA on the CUDA cores (67 TFLOP/s peak), so it is bound by arithmetic,
// not memory; it serves the calls the tensor-core kernel cannot take, and f32
// calls must not go to the tensor cores, whose f32 input path (TF32) keeps
// fewer bits than the f32 contract.

#include <cuda.h>  // CUtensorMap and its enums only: the driver is reached through
                   // cudaGetDriverEntryPoint, so the library needs no -lcuda
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_ptx.cuh"
#include "launch.cuh"

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

// The CUDA-core kernel ("simt"). dtype: 0 = float32, 1 = bfloat16. device is
// the index of the card the operands and the stream belong to. Returns
// cudaGetLastError() after the launch (0 when it was accepted). V and O must
// be positive.
extern "C" int fused_sage_matmul_launch(
    const void* h, const void* agg, const void* w_self, const void* w_nbr,
    const void* b, void* out, int V, int F, int O, int dtype, int relu,
    int device, void* stream) {
  const cudaError_t d = select_device(device);
  if (d != cudaSuccess) return static_cast<int>(d);
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

// ---- the tensor-core kernel ("tc") -----------------------------------------

namespace tc {

using namespace hopper;

constexpr int kBlockM = 128;               // output rows per tile: 2 warpgroups x 64
constexpr int kBlockK = 64;                // contraction depth per stage: 64 bf16 = 128 B
constexpr int kThreads = 384;              // warpgroup 0 loads, 1 and 2 multiply
constexpr int kConsumerWarps = 8;          // arrivals that free a stage
constexpr int kABytes = kBlockM * kBlockK * 2;   // one 128 x 64 slice of h or agg
constexpr int kBoxBytes = 64 * kBlockK * 2;      // one 64 x 64 box of a weight
constexpr int kRingBytes = 192 * 1024;     // shared memory for the ring of stages
// wgmma descriptors, in bytes. A (K-major): 8-row groups of 128-byte rows
// lie 1024 B apart. B (MN-major): in each 64-column box the 8-row groups of K
// lie 1024 B apart, and the boxes lie kBoxBytes apart.
constexpr uint32_t kASbo = 1024;
constexpr uint32_t kBLbo = kBoxBytes;
constexpr uint32_t kBSbo = 1024;

// A stage holds a 128 x 64 slice of h or agg and the matching 64 x BN slice
// of w_self or w_nbr: 48 KB and 4 stages for BN = 256, 32 KB and 6 for 128.
template <int BN>
struct Shape {
  static constexpr int kStageBytes = kABytes + BN * kBlockK * 2;
  static constexpr int kStages = kRingBytes / kStageBytes < 8 ? kRingBytes / kStageBytes : 8;
  // the ring, its 2 x kStages barriers, and slack to align the ring to 1024 B
  static constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db, int accumulate) {
  if constexpr (BN == 256) {
    wgmma_m64n256k16(d, da, db, accumulate);
  } else {
    wgmma_m64n128k16(d, da, db, accumulate);
  }
}

// k_half: 64-deep steps per contraction, ceil(F / 64); tiles: row tiles x
// tiles_n column tiles of width BN.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1) fused_sage_matmul_tc_kernel(
    const __grid_constant__ CUtensorMap map_h, const __grid_constant__ CUtensorMap map_agg,
    const __grid_constant__ CUtensorMap map_ws, const __grid_constant__ CUtensorMap map_wn,
    const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ out, int V, int O,
    int k_half, int tiles_n, int tiles, int relu) {
  using S = Shape<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // 128-byte swizzle wants 1024-B alignment
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + (ring - raw) +
                                               S::kStages * S::kStageBytes);
  uint64_t* empty = full + S::kStages;
  const int nk = 2 * k_half;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Loader warpgroup: one thread keeps the ring full, across tiles.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kBlockM;
        const int n0 = (tile % tiles_n) * BN;
        for (int k = 0; k < nk; ++k) {
          mbar_wait(&empty[stage], phase ^ 1u);  // the first pass finds every stage free
          mbar_arrive_expect_tx(&full[stage], S::kStageBytes);
          const bool self = k < k_half;
          const int kk = (self ? k : k - k_half) * kBlockK;
          const uint32_t a = ring + stage * S::kStageBytes;
          tma_load_2d(a, self ? &map_h : &map_agg, &full[stage], kk, m0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            tma_load_2d(a + kABytes + j * kBoxBytes, self ? &map_ws : &map_wn, &full[stage],
                        n0 + 64 * j, kk);
          }
          if (++stage == S::kStages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    // Multiplying warpgroups: consumer c owns rows 64c .. 64c + 63 of a tile.
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;  // each tile's first wgmma overwrites it
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      // This thread's bias pairs for the tile (columns 8j + 2q, +1), loaded
      // before the products so that their latency hides behind them;
      // columns past O read a valid address and are never stored.
      const int q = lane % 4;
      const int n0 = (tile % tiles_n) * BN;
      uint32_t bias[BN / 8];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = min(n0 + 8 * j + 2 * q, O - 2);
        bias[j] = __ldg(reinterpret_cast<const unsigned int*>(b + col));
      }
      int held = -1;  // the stage whose products may still be running
      for (int k = 0; k < nk; ++k) {
        mbar_wait(&full[stage], phase);
        const uint32_t a = ring + stage * S::kStageBytes + c * (64 * kBlockK * 2);
        const uint32_t bb = ring + stage * S::kStageBytes + kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) {
          // 16 deep: 32 B further along A's swizzled rows, 16 rows further down B
          wgmma_tile<BN>(acc, sw128_desc(a + 32 * kk, 16, kASbo),
                         sw128_desc(bb + 16 * 128 * kk, kBLbo, kBSbo), (k | kk) != 0);
        }
        wgmma_commit();
        // keep this step's products in flight; the previous step's are done,
        // so its stage goes back to the loader
        wgmma_wait<1>();
        if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
        held = stage;
        if (++stage == S::kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
      wgmma_wait<0>();
      fence_operands<BN / 2>(acc);
      if (lane == 0) mbar_arrive(&empty[held]);
      // Epilogue. Accumulator fragment of m64nNk16: for column group j, this
      // thread holds rows r and r + 8 at columns 8j + 2q and 8j + 2q + 1,
      // q = lane % 4. After bias, relu and the one rounding to bf16, a 4 x 4
      // transpose within each quad of lanes gives lane q all 8 columns of
      // group 4g + q, stored as one 16-byte write per row.
      const int row = (tile / tiles_n) * kBlockM + 64 * c + 16 * warp + lane / 4;
#pragma unroll
      for (int g = 0; g < BN / 32; ++g) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // rows r, then r + 8
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = 4 * g + i;
            // bf16 -> f32 is exact: the bf16 bits are the f32's upper half
            float v0 = acc[4 * j + 2 * half] + __uint_as_float(bias[j] << 16);
            float v1 = acc[4 * j + 2 * half + 1] + __uint_as_float(bias[j] & 0xffff0000u);
            if (relu) {
              v0 = fmaxf(v0, 0.0f);
              v1 = fmaxf(v1, 0.0f);
            }
            w[i] = pack_bf16x2(v0, v1);
          }
          // o[p] = word p of group 4g + q = w[q] of lane p of the quad
          uint32_t o[4] = {w[0], w[1], w[2], w[3]};
#pragma unroll
          for (int x = 1; x < 4; ++x) {
            const int p = q ^ x;
            const uint32_t send = p == 0 ? w[0] : p == 1 ? w[1] : p == 2 ? w[2] : w[3];
            const uint32_t got = __shfl_xor_sync(0xffffffffu, send, x);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              if (r == p) o[r] = got;
            }
          }
          const int col = n0 + 8 * (4 * g + q);  // O % 8 == 0: all 8 columns or none
          const int r = row + 8 * half;
          if (col < O && r < V) {
            *reinterpret_cast<uint4*>(out + (size_t)r * O + col) =
                make_uint4(o[0], o[1], o[2], o[3]);
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver the runtime has loaded.
cudaError_t encode_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A row-major [rows, cols] bf16 matrix, read in boxes of [box_rows, 64] with
// 128-byte swizzle; out-of-bounds elements read as zeros.
cudaError_t encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int rows, int cols,
                   int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// device is the current device (the launcher selected it): a function
// attribute belongs to one device, so it is set once per device.
template <int BN>
cudaError_t launch(const CUtensorMap* maps, const void* b, void* out, int V, int F, int O,
                   int relu, int num_sms, int device, cudaStream_t stream) {
  using S = Shape<BN>;
  static bool smem_set[kMaxDevices] = {};
  if (!smem_set[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_sage_matmul_tc_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::kSmemBytes);
    if (e != cudaSuccess) return e;
    smem_set[device] = true;
  }
  const int tiles_n = (O + BN - 1) / BN;
  const int tiles = ((V + kBlockM - 1) / kBlockM) * tiles_n;
  const int grid = tiles < num_sms ? tiles : num_sms;
  fused_sage_matmul_tc_kernel<BN><<<grid, kThreads, S::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const __nv_bfloat16*>(b),
      static_cast<__nv_bfloat16*>(out), V, O, (F + kBlockK - 1) / kBlockK, tiles_n, tiles,
      relu);
  return cudaGetLastError();
}

}  // namespace tc

// bf16 only; F and O positive multiples of 8 and every pointer 16-byte
// aligned (the caller checks). The card's SM count bounds the persistent
// grid. device is the index of the operands' card, selected before the maps
// are encoded. Returns a cudaError_t code (0 when the launch was accepted).
extern "C" int fused_sage_matmul_tc_launch(
    const void* h, const void* agg, const void* w_self, const void* w_nbr,
    const void* b, void* out, int V, int F, int O, int relu, int device, void* stream) {
  if (V <= 0 || F <= 0 || O <= 0 || F % 8 != 0 || O % 8 != 0 || device < 0 ||
      device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = select_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int num_sms = 0;
  e = sm_count(device, &num_sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  tc::EncodeTiledFn fn;
  e = tc::encode_fn(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap maps[4];
  const void* ptrs[4] = {h, agg, w_self, w_nbr};
  for (int i = 0; i < 4; ++i) {
    e = i < 2 ? tc::encode(fn, &maps[i], ptrs[i], V, F, tc::kBlockM)
              : tc::encode(fn, &maps[i], ptrs[i], F, O, tc::kBlockK);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // column tiles of 256 (one for config #5's first layer) or, for O <= 128,
  // of 128 (one for its second)
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = O > 128 ? tc::launch<256>(maps, b, out, V, F, O, relu, num_sms, device, s)
              : tc::launch<128>(maps, b, out, V, F, O, relu, num_sms, device, s);
  return static_cast<int>(e);
}
