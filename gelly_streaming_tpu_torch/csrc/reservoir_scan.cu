// The sampling estimators' per-edge reservoir scan, for Hopper (sm_90a): one
// cooperative launch a draw batch of edges.
//
// Replaces gelly_streaming_tpu/library/sampling.py:_window_scan (:50), an XLA
// step of the JAX package, not a Pallas kernel: there a window's edges go
// through one lax.scan dispatch whose step (:59-94) updates all k reservoir
// samples as vector operations. The port's torch form loops over the edges
// on the host and issues about 35 small launches an edge over the [k] state.
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
// The closed form, and why it is exact. A coin does not depend on the
// sample's state, so the state after the batch is fixed by L, the last edge
// whose coin came up (the reference's own "last occurrence" argument, its
// _window_vectorized, :108-125, applied inside one batch with the given
// uniforms). Without an L the fields stay and each flag is its old value OR
// "the carried pair ({src, third}, {trg, third}) occurs in the batch". With
// one, (src, trg) = (s, d) of edge L, third comes from u_third[L, j] alone
// (no other u_third entry is ever read), and each flag is "the new pair
// occurs at some edge after L": a replacement clears both flags, and the
// check at edge L itself never hits, since c differs from both its ends.
// That is the same function as the edge-by-edge step, bit for bit.
//
// The design. Walked edge by edge, the scan has only k threads of
// parallelism, each a chain of n dependent steps (at k = 10,000 about 2.4
// warps an SM, too few to hide device-memory latency). The closed form reads
// every coin independently, in one cooperative launch (a persistent grid of
// occupancy x SMs, cg::this_grid().sync() between phases):
//
//   phase 1: the [n, k] coin matrix in items of (slice of rows, tile of up to
//            128 columns), a block an item. A thread owns 4 columns of a
//            tile (one float4 where k % 4 == 0 and the matrix is 16-byte
//            aligned, else 4 coalesced scalar loads) and kRows rows of each
//            round, all loads of a round in flight at once; the round's
//            thresholds and pair keys are staged in shared memory. It keeps
//            the last row whose coin came up and whether a carried pair
//            occurred; the block reduces its row lanes and writes one word
//            a (slice, sample) to scratch with a plain store: every word is
//            written, nothing needs zeroing, no atomics.
//   grid barrier
//   phase 2: a warp a sample reduces its slices to L and the carried hits,
//            writes the fields, computes third from u_third[L, j] and looks
//            for the new pairs among the edges after L up to the end of
//            L + 1's chunk of kChunk edges (the whole batch at the main
//            path's 1677 edges).
//   grid barrier, only where n > kChunk (a long tail at small k)
//   phase 3: a warp an item (sample, later chunk) searches the rest of the
//            tail; a hit stores a 1 into the flag (the same value from any
//            item, so block order does not change the result).
//
// What bounds it now. The work must read the coins once (4nk bytes), the
// edges and the state once, write the state once and read k third draws:
// 4nk + 8n + 32k bytes, 67 MB and 0.020 ms at 3.35 TB/s for 1677 edges at
// k = 10,000. Phase 1 streams the coins; the scratch (4 bytes a slice and
// sample) and the edges' re-reads in phases 2-3 stay in L2. Phase 2's tail
// search is linear: its compares add up to the replaced samples' tails,
// most in a stream's first batches, where nearly every sample is replaced
// (later, about k n / m0 samples a batch). PERF.md has what it reaches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;         // a block
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;              // rows a thread loads at once (a round)
constexpr int kMaxGroups = 32;        // column groups of 4 a tile: 128 columns
constexpr int kMaxRoundRows = kThreads * kRows;  // a round at one group
constexpr int kChunk = 4096;          // tail edges a warp searches in one go
constexpr long long kMaxSlices = 1024;

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
  const int* es;         // [n] the batch's source ids
  const int* ed;         // [n] its target ids
  const float* u_coin;   // [n, k]
  const float* u_third;  // [n, k]
  unsigned* slice_word;  // [slices, k] scratch: (last local row + 1) << 2 | hits
  int* last;             // [k] scratch: L, or -1 (read by phase 3 only)
  long long m0;          // edges seen before the batch
  int n;
  int k;
  int vertex_count;
  int groups;      // column groups of 4 a tile
  int lanes;       // row lanes a block: kThreads / groups
  int slice_rows;  // rows a slice, a multiple of lanes * kRows
  int slices;
  int tiles;
  bool vec;        // the coins as float4
};

// The pair {u, v} as one 64-bit key: (min, max), so that two pairs are equal
// as sets exactly when their keys are equal.
__device__ __forceinline__ unsigned long long pair_key(int u, int v) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(min(u, v))) << 32) |
         static_cast<unsigned>(max(u, v));
}

// Column q of group g of a tile, as an offset in the tile: 4 neighbours for
// the float4 load, else a stride of `groups`, so that each scalar load of a
// warp reads neighbouring columns.
__device__ __forceinline__ int tile_column(const ScanArgs& a, int g, int q) {
  return a.vec ? 4 * g + q : q * a.groups + g;
}

struct Shared {
  float thr[kMaxRoundRows];               // float32(1 / float32(m)) of a round's rows
  unsigned long long key[kMaxRoundRows];  // pair_key(s, d)
  unsigned word[kThreads * 4];            // a thread's 4 words, for the block's reduction
};

// Phase 1 for one item: the rows [row0, row_end) through the tile's columns.
__device__ void fold_item(const ScanArgs& a, Shared& sh, int slice, int tile) {
  const int g = threadIdx.x % a.groups;
  const int lane = threadIdx.x / a.groups;
  const bool on = lane < a.lanes;
  const int tile_cols = 4 * a.groups;
  const int col0 = tile * tile_cols;
  const int row0 = slice * a.slice_rows;
  const int row_end = static_cast<int>(min(static_cast<long long>(a.n),
                                            static_cast<long long>(row0) + a.slice_rows));
  const int round_rows = a.lanes * kRows;
  unsigned long long close_src[4], close_trg[4];
  bool valid[4];
  int last[4];
  unsigned hits[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = col0 + tile_column(a, g, q);
    valid[q] = on && j < a.k;
    close_src[q] = close_trg[q] = ~0ULL;
    if (valid[q]) {
      close_src[q] = pair_key(a.src_in[j], a.third_in[j]);
      close_trg[q] = pair_key(a.trg_in[j], a.third_in[j]);
    }
    last[q] = -1;
    hits[q] = 0;
  }
  for (int base = row0; base < row_end; base += round_rows) {
    // the round's coins first, so that they are in flight while it stages
    float u[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = base + lane + r * a.lanes;
      const size_t at = static_cast<size_t>(i) * a.k + col0;
      if (on && i < row_end && a.vec && valid[0]) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(a.u_coin + at + 4 * g));
        u[r][0] = v.x;
        u[r][1] = v.y;
        u[r][2] = v.z;
        u[r][3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // 2 never falls below a threshold (at most 1)
          u[r][q] = (!a.vec && i < row_end && valid[q])
                        ? __ldcs(a.u_coin + at + tile_column(a, g, q))
                        : 2.0f;
        }
      }
    }
    __syncthreads();  // the last round's readers are done
    for (int e = threadIdx.x; e < round_rows && base + e < row_end; e += kThreads) {
      const int i = base + e;
      sh.thr[e] = __fdiv_rn(1.0f, __ll2float_rn(a.m0 + i + 1));
      sh.key[e] = pair_key(a.es[i], a.ed[i]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int e = lane + r * a.lanes;
      if (on && base + e < row_end) {
        const float thr = sh.thr[e];
        const unsigned long long key = sh.key[e];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (u[r][q] < thr) last[q] = base + e - row0;  // rows rise with r
          hits[q] |= static_cast<unsigned>(key == close_src[q]) |
                     (static_cast<unsigned>(key == close_trg[q]) << 1);
        }
      }
    }
  }
  // the block's row lanes to one word a column
  __syncthreads();
  if (on) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sh.word[lane * tile_cols + tile_column(a, g, q)] =
          (static_cast<unsigned>(last[q] + 1) << 2) | hits[q];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < tile_cols; c += kThreads) {
    const int j = col0 + c;
    if (j < a.k) {
      unsigned top = 0, any = 0;
      for (int l = 0; l < a.lanes; ++l) {
        const unsigned w = sh.word[l * tile_cols + c];
        top = max(top, w >> 2);
        any |= w & 3u;
      }
      a.slice_word[static_cast<size_t>(slice) * a.k + j] = (top << 2) | any;
    }
  }
  __syncthreads();  // sh.word is free for the next item
}

// Whether the pairs with keys cs, ct occur among edges [from, to): bit 0 for
// cs, bit 1 for ct, the same in every lane of the warp.
__device__ __forceinline__ unsigned tail_hits(const ScanArgs& a, int from, int to,
                                              unsigned long long cs, unsigned long long ct) {
  const int lane = threadIdx.x & 31;
  unsigned f = 0;
  for (int i0 = from; i0 < to; i0 += 4 * 32) {
    int s[4], d[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q * 32 + lane;
      s[q] = i < to ? a.es[i] : -1;
      d[q] = i < to ? a.ed[i] : -1;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (i0 + q * 32 + lane < to) {
        const unsigned long long key = pair_key(s[q], d[q]);
        f |= static_cast<unsigned>(key == cs) | (static_cast<unsigned>(key == ct) << 1);
      }
    }
  }
  return __reduce_or_sync(0xffffffffu, f);
}

// The first edge after the chunk that holds edge i.
__device__ __forceinline__ int chunk_end(int i) { return (i / kChunk + 1) * kChunk; }

__global__ void __launch_bounds__(kThreads) reservoir_scan(const ScanArgs a) {
  __shared__ Shared sh;
  cg::grid_group grid = cg::this_grid();
  const int items = a.slices * a.tiles;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    fold_item(a, sh, item / a.tiles, item % a.tiles);
  }
  grid.sync();

  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int n_warps = gridDim.x * kWarps;
  const bool long_tail = a.n > kChunk;
  for (int j = warp; j < a.k; j += n_warps) {
    int top = -1;
    unsigned any = 0;
    for (int sl = lane; sl < a.slices; sl += 32) {
      const unsigned w = a.slice_word[static_cast<size_t>(sl) * a.k + j];
      if (w >> 2) top = max(top, sl * a.slice_rows + static_cast<int>(w >> 2) - 1);
      any |= w & 3u;
    }
    const int L = __reduce_max_sync(0xffffffffu, top);
    any = __reduce_or_sync(0xffffffffu, any);
    if (L < 0) {
      if (lane == 0) {
        a.src_out[j] = a.src_in[j];
        a.trg_out[j] = a.trg_in[j];
        a.third_out[j] = a.third_in[j];
        a.sf_out[j] = a.sf_in[j] | (any & 1u);
        a.tf_out[j] = a.tf_in[j] | (any >> 1);
      }
    } else {
      const int s = a.es[L], d = a.ed[L];
      const int u1 = min(s, d), u2 = max(s, d);
      const int nv = a.vertex_count - 1 - (u1 != u2);
      const float ut = a.u_third[static_cast<size_t>(L) * a.k + j];
      int c = min(__float2int_rz(__fmul_rn(ut, __int2float_rn(nv))), nv - 1);
      c += c >= u1;
      c += (u1 != u2) & (c >= u2);
      const unsigned f = tail_hits(a, L + 1, min(a.n, chunk_end(L + 1)), pair_key(s, c),
                                   pair_key(d, c));
      if (lane == 0) {
        a.src_out[j] = s;
        a.trg_out[j] = d;
        a.third_out[j] = c;
        a.sf_out[j] = f & 1u;
        a.tf_out[j] = f >> 1;
      }
    }
    if (long_tail && lane == 0) a.last[j] = L;
  }
  if (!long_tail) return;  // the same for every thread of the grid
  grid.sync();

  const int chunks = (a.n + kChunk - 1) / kChunk;
  const long long work = static_cast<long long>(a.k) * chunks;
  for (long long item = warp; item < work; item += n_warps) {
    const int j = static_cast<int>(item / chunks);
    const int from = static_cast<int>(item % chunks) * kChunk;
    const int L = a.last[j];
    // phase 2 searched up to chunk_end(L + 1)
    if (L < 0 || from < chunk_end(L + 1)) continue;
    const int third = a.third_out[j];
    const unsigned f = tail_hits(a, from, min(a.n, from + kChunk),
                                 pair_key(a.src_out[j], third), pair_key(a.trg_out[j], third));
    if (lane == 0) {
      if (f & 1u) a.sf_out[j] = 1;
      if (f & 2u) a.tf_out[j] = 1;
    }
  }
}

// The grid and the slices of a batch on one card.
struct Plan {
  int blocks;
  int groups, lanes, tiles, slice_rows, slices;
};

// The most blocks of the cooperative grid on each card: 0 until read.
std::atomic<int> g_max_blocks[kMaxDevices];

// Slices of whole rounds, about two items a block of the full grid, at most
// kMaxSlices; the grid no larger than the work.
Plan plan(int n, int k, int most) {
  Plan p;
  p.groups = std::min(kMaxGroups, (k + 3) / 4);
  p.lanes = kThreads / p.groups;
  p.tiles = (k + 4 * p.groups - 1) / (4 * p.groups);
  const long long round = static_cast<long long>(p.lanes) * kRows;
  const long long rounds_n = (static_cast<long long>(n) + round - 1) / round;
  const long long by_items = (rounds_n * p.tiles + 2LL * most - 1) / (2LL * most);
  const long long by_cap = (rounds_n + kMaxSlices - 1) / kMaxSlices;
  const long long rounds = std::max({1LL, by_items, by_cap});
  p.slice_rows = static_cast<int>(std::min(rounds * round, static_cast<long long>(INT_MAX)));
  p.slices = static_cast<int>((static_cast<long long>(n) + p.slice_rows - 1) / p.slice_rows);
  const int chunks = (n + kChunk - 1) / kChunk;
  const long long warps = static_cast<long long>(k) * std::max(1, chunks);
  const long long need = std::max(static_cast<long long>(p.slices) * p.tiles,
                                  (warps + kWarps - 1) / kWarps);
  p.blocks = static_cast<int>(std::max(1LL, std::min(static_cast<long long>(most), need)));
  return p;
}

// n stays below INT_MAX by a margin, so that a round's or a chunk's end
// past the last row does not overflow
bool bad_sizes(long long m0, int n, int k, int vertex_count, int device) {
  return n < 0 || n > INT_MAX - (1 << 16) || k <= 0 || m0 < 0 || vertex_count < 3 ||
         device < 0 || m0 > LLONG_MAX - n;
}

}  // namespace

// The scratch of a batch of n edges through k samples on card `device`, in
// 4-byte words; negative: minus a cudaError code.
extern "C" long long reservoir_scan_scratch_words(int n, int k, int device) {
  if (bad_sizes(0, n, k, 3, device)) return -static_cast<long long>(cudaErrorInvalidValue);
  cudaError_t e = select_device(device);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  int most = 0;
  e = cooperative_blocks(reinterpret_cast<const void*>(reservoir_scan), kThreads, 0, device,
                         g_max_blocks, &most);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  return (static_cast<long long>(plan(n, k, most).slices) + 1) * k;
}

// One batch on `stream` of card `device`. state_in and state_out: the five
// [k] columns each (src, trg, third int32; src_found, trg_found one byte
// each), distinct; es, ed: [n] int32 raw ids; u_coin, u_third: [n, k]
// float32, row-major; scratch: reservoir_scan_scratch_words(n, k, device)
// 4-byte words, 4-byte aligned, any contents; m0: the edges seen before the
// batch. Returns the launch's error code (0 when it was accepted).
extern "C" int reservoir_scan_launch(const void* src_in, const void* trg_in,
                                     const void* third_in, const void* sf_in,
                                     const void* tf_in, void* src_out, void* trg_out,
                                     void* third_out, void* sf_out, void* tf_out,
                                     const void* es, const void* ed, const void* u_coin,
                                     const void* u_third, void* scratch,
                                     long long scratch_words, long long m0, int n, int k,
                                     int vertex_count, int device, void* stream) {
  if (bad_sizes(m0, n, k, vertex_count, device)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = select_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int most = 0;
  e = cooperative_blocks(reinterpret_cast<const void*>(reservoir_scan), kThreads, 0, device,
                         g_max_blocks, &most);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = plan(n, k, most);
  // a slice's last row + 1 must fit a word's upper 30 bits
  if (p.slice_rows >= (1 << 30) || scratch_words < (static_cast<long long>(p.slices) + 1) * k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  a.slice_word = static_cast<unsigned*>(scratch);
  a.last = static_cast<int*>(scratch) + static_cast<size_t>(p.slices) * k;
  a.m0 = m0;
  a.n = n;
  a.k = k;
  a.vertex_count = vertex_count;
  a.groups = p.groups;
  a.lanes = p.lanes;
  a.slice_rows = p.slice_rows;
  a.slices = p.slices;
  a.tiles = p.tiles;
  a.vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(u_coin) % 16 == 0;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(reservoir_scan), dim3(p.blocks),
                                  dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
