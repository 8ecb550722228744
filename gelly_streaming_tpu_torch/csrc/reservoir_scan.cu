// The sampling estimators' per-edge reservoir scan, for Hopper (sm_90a): one
// launch a draw batch of edges.
//
// Replaces gelly_streaming_tpu/library/sampling.py:_window_scan (:50), an XLA
// step of the JAX package, not a Pallas kernel: there a window's edges go
// through one lax.scan dispatch whose step (:59-94) updates all k reservoir
// samples as vector operations. The port's torch form loops over the edges
// on the host and issues about 35 small launches an edge over the [k] state,
// and on the card it is bound by those launches. This launch folds a whole
// batch of n edges through every sample.
//
// What it computes. Sample j holds (src, trg, third, src_found, trg_found).
// For edge i = 0 .. n-1 with raw ids (s, d), m = m0 + i + 1 edges seen so far:
//
//   coin  = u_coin[i, j] < float32(1 / float32(m))
//   u1, u2 = min(s, d), max(s, d); distinct = u1 != u2
//   nv    = vertex_count - 1 - distinct
//   c0    = min(int(u_third[i, j] * float32(nv)), nv - 1)   (truncated)
//   c     = c0 + (c0 >= u1); c += distinct and c >= u2
//   if coin: (src, trg, third) = (s, d, c); both flags cleared
//   src_found |= {s, d} == {src, third}; trg_found |= {s, d} == {trg, third}
//
// the checks against the state after the replacement, as the reference's
// step does. Every float32 operation rounds as the plain version's does: the
// threshold is __fdiv_rn of 1 by __ll2float_rn(m), the product __fmul_rn, the
// conversion __float2int_rz (the build uses no fast-math flag). Above 2^24 a
// float32 no longer holds m or nv exactly; both versions round them the same
// way, to nearest even.
//
// The design. The samples are independent and the edges are a sequence, so
// one thread owns one sample, keeps its fields in registers and walks the
// batch's edges in order; no atomics, so the result is deterministic. A
// block stages a tile of edges in shared memory with what depends on the
// edge alone: the pair key (min, max) of its ids, the threshold, the ids and
// nv as an int and a float. A thread keeps the keys of its two closing pairs
// {src, third} and {trg, third}, so an edge whose coin does not come up (all
// but about k/m of them) costs a compare with the threshold and two 64-bit
// key compares. For edge i a warp reads u_coin[i, j] and u_third[i, j] for
// its 32 consecutive samples, 128 bytes each, coalesced.
//
// What bounds it on this card. Every uniform is read once: 8 bytes a
// sample-step, 134 MB for a batch of 1677 edges at k = 10,000, so the byte
// bound is about 0.04 ms. The only parallelism is k: at k = 10,000 there are
// 313 warps, about 2.4 an SM, too few to hide device-memory latency with one
// load in flight each, and each warp reads 128 bytes of a different 40 KB row
// at every step. The uniforms do not depend on the state, so each thread
// loads the next group of kGroup edges' uniforms into registers while it
// folds the current group (two register buffers, 2 x 2 x kGroup floats),
// which keeps 2 x kGroup loads a warp in flight. PERF.md has what it reaches.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 64;  // samples a block: two warps, so k = 10,000 spreads over 157 blocks
constexpr int kGroup = 16;    // edges whose uniforms a thread loads at once
constexpr int kTile = 256;    // edges a block stages in shared memory; a multiple of 2 kGroup

static_assert(kTile % (2 * kGroup) == 0, "a tile must hold whole pairs of groups");

struct ScanArgs {
  const int* src_in;
  const int* trg_in;
  const int* third_in;
  const unsigned char* sf_in;
  const unsigned char* tf_in;
  int* src_out;
  int* trg_out;
  int* third_out;
  unsigned char* sf_out;
  unsigned char* tf_out;
  const int* es;  // [n] the batch's source ids
  const int* ed;  // [n] its target ids
  const float* u_coin;   // [n, k]
  const float* u_third;  // [n, k]
  long long m0;          // edges seen before the batch
  int n;
  int k;
  int vertex_count;
};

// The pair {u, v} as one 64-bit key: (min, max), so that two pairs are equal
// as sets exactly when their keys are equal.
__device__ __forceinline__ unsigned long long pair_key(int u, int v) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(min(u, v))) << 32) |
         static_cast<unsigned>(max(u, v));
}

// What a tile's edges need, staged once a block. The fold reads key and thr
// for every edge; the rest only where a coin comes up.
struct Tile {
  unsigned long long key[kTile];  // pair_key(s, d)
  float thr[kTile];               // float32(1 / float32(m))
  int s[kTile];
  int d[kTile];
  int nv_last[kTile];  // nv - 1
  float nv[kTile];     // float32(nv)
};

__device__ __forceinline__ void load_group(const ScanArgs& a, int first, int j, bool active,
                                           float (&uc)[kGroup], float (&ut)[kGroup]) {
#pragma unroll
  for (int q = 0; q < kGroup; ++q) {
    const int i = first + q;
    if (active && i < a.n) {
      const size_t at = static_cast<size_t>(i) * a.k + j;
      uc[q] = __ldcs(a.u_coin + at);
      ut[q] = __ldcs(a.u_third + at);
    }
  }
}

// A sample's state, with the pair keys of its two closing edges
// {src, third} and {trg, third}: edge {s, d} closes one exactly when its key
// equals that pair's (a self-loop {s, s} only the pair {s, s}), so a step
// that replaces nothing costs two key compares.
struct Sample {
  int src, trg, third;
  bool sf, tf;
  unsigned long long close_src, close_trg;
};

// Fold the group of edges starting at tile slot `slot` (of `count` valid
// slots in the tile) through one sample.
__device__ __forceinline__ void fold_group(const Tile& t, int slot, int count,
                                           const float (&uc)[kGroup],
                                           const float (&ut)[kGroup], Sample& x) {
#pragma unroll
  for (int q = 0; q < kGroup; ++q) {
    const int e = slot + q;
    if (e < count) {
      if (uc[q] < t.thr[e]) {
        const int s = t.s[e], d = t.d[e];
        const int u1 = min(s, d), u2 = max(s, d);
        int c = min(__float2int_rz(__fmul_rn(ut[q], t.nv[e])), t.nv_last[e]);
        c += c >= u1;
        c += (u1 != u2) & (c >= u2);
        x.src = s;
        x.trg = d;
        x.third = c;
        x.sf = false;
        x.tf = false;
        x.close_src = pair_key(s, c);
        x.close_trg = pair_key(d, c);
      }
      const unsigned long long key = t.key[e];
      x.sf |= key == x.close_src;
      x.tf |= key == x.close_trg;
    }
  }
}

__global__ void __launch_bounds__(kThreads) reservoir_scan(const ScanArgs a) {
  __shared__ Tile tile;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool active = j < a.k;
  Sample x{};
  if (active) {
    x.src = a.src_in[j];
    x.trg = a.trg_in[j];
    x.third = a.third_in[j];
    x.sf = a.sf_in[j] != 0;
    x.tf = a.tf_in[j] != 0;
    x.close_src = pair_key(x.src, x.third);
    x.close_trg = pair_key(x.trg, x.third);
  }
  float uc0[kGroup], ut0[kGroup], uc1[kGroup], ut1[kGroup];
  load_group(a, 0, j, active, uc0, ut0);
  for (int base = 0; base < a.n; base += kTile) {
    const int count = min(kTile, a.n - base);
    __syncthreads();  // the last tile's readers are done
    for (int e = threadIdx.x; e < count; e += kThreads) {
      const int s = a.es[base + e], d = a.ed[base + e];
      const int nv = a.vertex_count - 1 - (s != d);
      tile.key[e] = pair_key(s, d);
      tile.s[e] = s;
      tile.d[e] = d;
      tile.nv_last[e] = nv - 1;
      tile.nv[e] = __int2float_rn(nv);
      tile.thr[e] = __fdiv_rn(1.0f, __ll2float_rn(a.m0 + base + e + 1));
    }
    __syncthreads();
    for (int slot = 0; slot < count; slot += 2 * kGroup) {
      // uc0/ut0 hold this group's uniforms; load the next group's, fold
      // this one, then the same with the buffers swapped
      load_group(a, base + slot + kGroup, j, active, uc1, ut1);
      if (active) fold_group(tile, slot, count, uc0, ut0, x);
      load_group(a, base + slot + 2 * kGroup, j, active, uc0, ut0);
      if (active) fold_group(tile, slot + kGroup, count, uc1, ut1, x);
    }
  }
  if (active) {
    a.src_out[j] = x.src;
    a.trg_out[j] = x.trg;
    a.third_out[j] = x.third;
    a.sf_out[j] = x.sf;
    a.tf_out[j] = x.tf;
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

// One batch on `stream` of card `device`. state_in and state_out: the five
// [k] columns each (src, trg, third int32; src_found, trg_found one byte
// each), distinct; es, ed: [n] int32 raw ids; u_coin, u_third: [n, k]
// float32, row-major; m0: the edges seen before the batch. Returns the
// launch's error code (0 when it was accepted).
extern "C" int reservoir_scan_launch(const void* src_in, const void* trg_in,
                                     const void* third_in, const void* sf_in,
                                     const void* tf_in, void* src_out, void* trg_out,
                                     void* third_out, void* sf_out, void* tf_out,
                                     const void* es, const void* ed, const void* u_coin,
                                     const void* u_third, long long m0, int n, int k,
                                     int vertex_count, int device, void* stream) {
  if (n < 0 || k <= 0 || m0 < 0 || vertex_count < 3 || device < 0 ||
      m0 > LLONG_MAX - n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = select_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  ScanArgs a;
  a.src_in = static_cast<const int*>(src_in);
  a.trg_in = static_cast<const int*>(trg_in);
  a.third_in = static_cast<const int*>(third_in);
  a.sf_in = static_cast<const unsigned char*>(sf_in);
  a.tf_in = static_cast<const unsigned char*>(tf_in);
  a.src_out = static_cast<int*>(src_out);
  a.trg_out = static_cast<int*>(trg_out);
  a.third_out = static_cast<int*>(third_out);
  a.sf_out = static_cast<unsigned char*>(sf_out);
  a.tf_out = static_cast<unsigned char*>(tf_out);
  a.es = static_cast<const int*>(es);
  a.ed = static_cast<const int*>(ed);
  a.u_coin = static_cast<const float*>(u_coin);
  a.u_third = static_cast<const float*>(u_third);
  a.m0 = m0;
  a.n = n;
  a.k = k;
  a.vertex_count = vertex_count;
  const unsigned blocks = static_cast<unsigned>((k + kThreads - 1) / kThreads);
  reservoir_scan<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* reservoir_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
