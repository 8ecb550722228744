// The k >= 3 spanner's k-hop search, for Hopper (sm_90a): one launch a search.
//
// Replaces gelly_streaming_tpu/library/spanner.py:_k_reach_cnt (:103), an XLA
// step of the JAX package: there each hop gathers every spanner entry's
// source words and ORs each target's run of them with a segmented
// associative_scan over the entries sorted by target. Here the entries come
// sorted by target once a window (row_ptr, src: a CSR by target, built with
// torch by ops/reach_kernels.py:target_csr), and one cooperative launch runs
// the whole search of a batch of B queries: the seed, k hops, the read-out,
// and the clearing of its scratch. Query i owns bit i % 32 of word i / 32, so
// a vertex's frontier row is W = B / 32 int32 words, and R_h[t] is vertex t's
// row after h hops:
//
//     R_0[u[i]] has bit i for every unmasked query i
//     R_h[t] = R_{h-1}[t] | OR over s in N(t) of R_{h-1}[s]      (h = 1..k)
//     answer i = m[i] and bit i of R_k[v[i]]
//
// N(t) is target t's sources, src[row_ptr[t] .. row_ptr[t + 1]).
//
// What bounds it. A hop of the dense form reads the row of every source of
// every target (2S rows: 201 MB at the spanner_k3_eps cell's window 3) and
// reads and writes all V rows, although most sources' rows are zero or did
// not change in the hop before. This design moves only what changes, so its
// traffic is the active rows' and not the dense frontier's, and what is left
// is the latency of dependent loads (a target's bounds, its sources, then
// their rows) and the grid's barriers. Bitmaps of one bit a vertex say which
// rows matter:
//
// - changed_h: the rows that hop h changed (changed_0: the seeded vertices);
// - nonzero_h: the rows that are non-zero after hop h.
//
// Why gathering only the changed sources is exact: a source whose row did
// not change in hop h-1 has R_{h-1}[s] = R_{h-2}[s], and hop h-1 already ORed
// R_{h-2}[s] into R_{h-1}[t]; so hop h needs only the sources in changed_{h-1}.
// Rows only grow, so a word that is zero in R_h is zero in R_{h-2} too: the
// hop reads one frontier and writes the other (it stays synchronous: the
// buffer it writes holds R_{h-2}), writes every non-zero word, and skips the
// zero ones, which are zero there already. A target's own row is read only
// where nonzero_{h-1} has its bit.
//
// The launch. A persistent cooperative grid (as many blocks as fit on the
// card at once) with grid-wide barriers between the phases:
//
// 1. seed: each unmasked query adds its bit to its word of row u[i] (distinct
//    queries carry distinct bits, so the sum is the OR, and bit 31 adds as
//    the int32 -2^31) and sets u[i]'s bits in changed_0 and nonzero_0;
// 2. hops 1..k, between two [V, W] frontiers. A group of g lanes takes a
//    target, each lane moving 16 bytes of a row (an int4) where W is a
//    multiple of 4, else 4 bytes: g is the least power of two >= min(vectors
//    a row, 32), so at W = 32 a row is one 128-byte line read by 8 lanes and a
//    warp runs 4 targets at once. A warp takes 32 / g consecutive targets at
//    a time by a grid stride, so the hot low ids of a skewed stream spread
//    over many warps. The group reads its target's sources g at a time in
//    one coalesced load, tests their bits in changed_{h-1} (a __ballot_sync,
//    then __ffs and __shfl_sync over the set bits) and gathers only those
//    sources' rows, four in flight; every loop runs in step across the warp,
//    so the warp's groups issue their loads together. A target's bounds and
//    own bit are loaded one step ahead and its first sources at the end of
//    the step before. The warp ORs its targets' bits of changed_h and
//    nonzero_h into their word with one atomic each. Each kind of bitmap has
//    three slots: hop h writes slot h % 3 and clears slot (h + 1) % 3, which
//    held hop h-2's bits and which no one reads any more, for the hop after.
//    At the start of a hop each block stages changed_{h-1} into shared
//    memory with one 1-D bulk copy (cp.async.bulk completing on an mbarrier)
//    where V / 8 bytes fit in a block (32 KB at V = 2^18); above that the
//    bits are read from device memory. The launcher picks the path from V.
// 3. read-out: answer i from bit i of R_k[v[i]];
// 4. clearing: the rows set in nonzero_k in the frontier that holds R_k and
//    those set in nonzero_{k-1} in the other one (which holds R_{k-1}; its
//    other rows are zero), and all six bitmaps. The scratch is all zero when
//    the launch ends, as it must be when the next one starts: the wrapper
//    allocates it zeroed once and never fills it again.
//
// The frontier is vertex-major, so one vertex's W words are one contiguous
// row. The frontier words and the bitmaps are read with plain loads (not
// __ldg): the launch writes them itself.
//
// k_reach_hop below is the earlier design, one launch a hop over the dense
// frontier; no path of the port calls it, and it stays to time and check the
// search against.

#include <algorithm>
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hopper_ptx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSearchThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
// bitmaps of each kind: hop h writes slot h % 3 and clears slot (h + 1) % 3
// for the hop after it, which no hop reads any more (it held hop h-2's)
constexpr int kSlots = 3;

struct SearchArgs {
  const int* row_ptr;       // [V + 1]
  const int* src;           // the sources in target order
  const int* u;             // [B]
  const int* v;             // [B]
  const unsigned char* m;   // [B] bool
  int* front0;              // [V, W]
  int* front1;              // [V, W]
  // kSlots bitmaps of `bitmap_words` words of changed rows, then kSlots of
  // non-zero rows: hop h's in slot h % kSlots
  unsigned* bits;
  unsigned char* out;       // [B] bool
  int V, W, B, k, bitmap_words, g_log2;
};

// A row's words moved kVec at a time: int4 (16 bytes a lane) where W is a
// multiple of 4, else one int.
template <int kVec>
struct Vec;

template <>
struct Vec<1> {
  using T = int;
  __device__ static T zero() { return 0; }
  __device__ static T load(const int* p) { return *p; }
  __device__ static void store(int* p, T x) { *p = x; }
  __device__ static T bor(T a, T b) { return a | b; }
  __device__ static bool any(T a) { return a != 0; }
  __device__ static bool differ(T a, T b) { return a != b; }
};

template <>
struct Vec<4> {
  using T = int4;
  __device__ static T zero() { return make_int4(0, 0, 0, 0); }
  __device__ static T load(const int* p) { return *reinterpret_cast<const int4*>(p); }
  __device__ static void store(int* p, T x) { *reinterpret_cast<int4*>(p) = x; }
  __device__ static T bor(T a, T b) {
    return make_int4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
  }
  __device__ static bool any(T a) { return (a.x | a.y | a.z | a.w) != 0; }
  __device__ static bool differ(T a, T b) {
    return ((a.x ^ b.x) | (a.y ^ b.y) | (a.z ^ b.z) | (a.w ^ b.w)) != 0;
  }
};

// OR into this lane's vector `x` the rows of its group's sources `s` whose
// lane bits are set in `hits` (relative to the group, whose first lane is
// `lane0`), four rows in flight at a time. The loop runs in step across the
// warp (every group to the last group's end), so the warp's groups issue
// their loads together.
template <int kVec>
__device__ __forceinline__ void gather_rows(const int* prev, size_t W, bool okx, int x, int s,
                                            unsigned hits, int lane0,
                                            typename Vec<kVec>::T& acc) {
  using V = Vec<kVec>;
  while (__any_sync(kFull, hits != 0)) {
    int sb[4];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ok[j] = hits != 0;
      const int b = ok[j] ? __ffs(hits) - 1 : 0;
      hits &= hits - 1;
      sb[j] = __shfl_sync(kFull, s, lane0 + b);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ok[j] && okx) {
        acc = V::bor(acc, V::load(prev + static_cast<size_t>(sb[j]) * W + x * kVec));
      }
    }
  }
}

template <bool kStaged, int kVec>
__global__ void __launch_bounds__(kSearchThreads) k_reach_search(SearchArgs a) {
  using V = Vec<kVec>;
  extern __shared__ __align__(16) unsigned staged[];
  __shared__ __align__(8) uint64_t bar;
  cg::grid_group grid = cg::this_grid();
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  const size_t W = static_cast<size_t>(a.W);
  const size_t words = static_cast<size_t>(a.bitmap_words);
  // slot c of the changed bitmaps, and of the non-zero ones
  auto changed = [&](int c) { return a.bits + c * words; };
  auto nonzero = [&](int c) { return a.bits + (kSlots + c) * words; };
  if (kStaged) {
    if (threadIdx.x == 0) {
      hopper::mbar_init(&bar, 1);
      hopper::fence_barrier_init();
    }
    __syncthreads();
  }

  // 1. seed
  for (long long i = tid; i < a.B; i += nthreads) {
    if (__ldg(a.m + i)) {
      const int x = __ldg(a.u + i);
      atomicAdd(a.front0 + static_cast<size_t>(x) * W + (i >> 5),
                static_cast<int>(1u << (i & 31)));
      atomicOr(changed(0) + (x >> 5), 1u << (x & 31));
      atomicOr(nonzero(0) + (x >> 5), 1u << (x & 31));
    }
  }
  grid.sync();

  // 2. hops. A warp takes `groups` consecutive targets at a time (one a
  // group: all in one bitmap word) by a grid stride. Every loop below runs
  // in step across the warp; a lane's group and target only predicate its
  // loads and stores.
  const int lane = threadIdx.x & 31;
  const long long warp = tid >> 5;
  const long long nwarps = nthreads >> 5;
  const int nvec = a.W / kVec;          // vectors a row
  const int g = 1 << a.g_log2;          // lanes a target
  const int groups = 32 >> a.g_log2;    // targets a warp at a time
  const int q = lane >> a.g_log2;       // this lane's group
  const int r = lane & (g - 1);         // its rank in the group
  const int lane0 = q * g;              // the group's first lane
  const unsigned low = g == 32 ? kFull : (1u << g) - 1;
  const long long steps = (a.V + groups - 1) / groups;
  for (int h = 1; h <= a.k; ++h) {
    const int* prev = h & 1 ? a.front0 : a.front1;
    int* next = h & 1 ? a.front1 : a.front0;
    const unsigned* nprev = nonzero((h - 1) % kSlots);
    const unsigned* test = changed((h - 1) % kSlots);
    unsigned* cnext = changed(h % kSlots);
    unsigned* nnext = nonzero(h % kSlots);
    if (kStaged && threadIdx.x == 0) {
      hopper::fence_proxy_async();  // the bits were written through the generic proxy
      hopper::mbar_arrive_expect_tx(&bar, a.bitmap_words * 4u);
      hopper::bulk_load_1d(hopper::smem_u32(staged), test, a.bitmap_words * 4u, &bar);
    }
    // the slots the next hop writes: they hold hop h-2's bits, which no one
    // reads any more
    for (long long i = tid; i < a.bitmap_words; i += nthreads) {
      changed((h + 1) % kSlots)[i] = 0;
      nonzero((h + 1) % kSlots)[i] = 0;
    }
    // A step's operands are loaded one step ahead: its bounds and its own
    // bit while the step before runs, its first source at the end of that
    // step, so that a step waits on one load, not on a chain of three.
    long long step = warp;
    int t = static_cast<int>(step * groups) + q;
    bool valid = step < steps && t < a.V;
    int begin = valid ? __ldg(a.row_ptr + t) : 0;
    int end = valid ? __ldg(a.row_ptr + t + 1) : 0;
    unsigned own_word = valid ? nprev[t >> 5] : 0u;
    int first_src = begin + r < end ? __ldg(a.src + begin + r) : 0;
    if (kStaged) {
      hopper::mbar_wait(&bar, (h - 1) & 1);
      test = staged;
    }
    for (; step < steps; step += nwarps) {
      const long long step_n = step + nwarps;
      const int t_n = static_cast<int>(step_n * groups) + q;
      const bool valid_n = step_n < steps && t_n < a.V;
      const int begin_n = valid_n ? __ldg(a.row_ptr + t_n) : 0;
      const int end_n = valid_n ? __ldg(a.row_ptr + t_n + 1) : 0;
      const unsigned own_word_n = valid_n ? nprev[t_n >> 5] : 0u;

      const int t0 = static_cast<int>(step * groups);
      const bool own = (own_word >> (t & 31)) & 1u;
      const int* prow = prev + static_cast<size_t>(t) * W;
      int* nrow = next + static_cast<size_t>(t) * W;
      const int chunks = __reduce_max_sync(kFull, (end - begin + g - 1) >> a.g_log2);
      bool nz = false, ch = false;
      for (int x = r; x - r < nvec; x += g) {  // passes over the row's vectors
        const bool okx = valid && x < nvec;
        const typename V::T old = own && okx ? V::load(prow + x * kVec) : V::zero();
        typename V::T acc = old;
        for (int c = 0; c < chunks; ++c) {
          const int e = begin + (c << a.g_log2) + r;
          int s = 0;
          bool hit = false;
          if (e < end) {
            s = c == 0 ? first_src : __ldg(a.src + e);
            hit = (test[s >> 5] >> (s & 31)) & 1u;
          }
          const unsigned hits = (__ballot_sync(kFull, hit) >> lane0) & low;
          gather_rows<kVec>(prev, W, okx, x, s, hits, lane0, acc);
        }
        if (okx && V::any(acc)) V::store(nrow + x * kVec, acc);
        nz |= V::any(acc);
        ch |= V::differ(acc, old);
      }
      first_src = begin_n + r < end_n ? __ldg(a.src + begin_n + r) : 0;
      // one bit a group, the warp's targets' bits of one word
      const unsigned nzb = __ballot_sync(kFull, nz), chb = __ballot_sync(kFull, ch);
      const bool mine = lane < groups;
      const unsigned nz_bits = __ballot_sync(kFull, mine && ((nzb >> (mine ? lane * g : 0)) & low));
      const unsigned ch_bits = __ballot_sync(kFull, mine && ((chb >> (mine ? lane * g : 0)) & low));
      if (lane == 0 && nz_bits) atomicOr(nnext + (t0 >> 5), nz_bits << (t0 & 31));
      if (lane == 0 && ch_bits) atomicOr(cnext + (t0 >> 5), ch_bits << (t0 & 31));
      t = t_n;
      valid = valid_n;
      begin = begin_n;
      end = end_n;
      own_word = own_word_n;
    }
    grid.sync();  // also orders this hop's reads of `staged` before the next copy
  }

  // 3. read-out
  int* fin = a.k & 1 ? a.front1 : a.front0;
  for (long long i = tid; i < a.B; i += nthreads) {
    unsigned char hit = 0;
    if (__ldg(a.m + i)) {
      const unsigned word = static_cast<unsigned>(
          fin[static_cast<size_t>(__ldg(a.v + i)) * W + (i >> 5)]);
      hit = (word >> (i & 31)) & 1u;
    }
    a.out[i] = hit;
  }
  grid.sync();

  // 4. clearing: R_k's rows, R_{k-1}'s rows (no bits before the seed), the
  // bitmaps; a warp a word of them
  int* other = a.k & 1 ? a.front0 : a.front1;
  const unsigned* nfin = nonzero(a.k % kSlots);
  const unsigned* nother = nonzero((a.k + kSlots - 1) % kSlots);
  const int tile_vecs = 32 * nvec;
  for (long long tile = warp; tile < a.bitmap_words; tile += nwarps) {
    const unsigned zf = nfin[tile];
    const unsigned zo = a.k ? nother[tile] : 0u;
    if (zf | zo) {
      int* f = fin + static_cast<size_t>(tile) * 32 * W;
      int* o = other + static_cast<size_t>(tile) * 32 * W;
      for (int x = lane; x < tile_vecs; x += 32) {
        const int row = x / nvec;
        if ((zf >> row) & 1u) V::store(f + x * kVec, V::zero());
        if ((zo >> row) & 1u) V::store(o + x * kVec, V::zero());
      }
    }
    __syncwarp();
    if (lane < 2 * kSlots) a.bits[lane * words + tile] = 0;
  }
}

// The earlier design, one launch a hop over the dense frontier, in -> out
// (distinct buffers): out[t, w] = in[t, w] | OR over t's sources s of
// in[s, w], for every target t < V and word w < W; g lanes a target (g the
// least power of two >= min(W, 32)), each lane a word, four source rows in
// flight a lane.
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

// log2 of the lanes a target: the least power of two >= min(W, 32)
int lanes_log2(int W) {
  int g_log2 = 0;
  while ((1 << g_log2) < W && g_log2 < 5) ++g_log2;
  return g_log2;
}

// Words of one bitmap over V vertices: one bit a vertex, padded to whole
// 16-byte lines (the bulk copy's unit).
int bitmap_words(int V) { return 4 * ((V + 127) / 128); }

// Whether a search over V vertices stages its changed bitmap in shared
// memory on `device`: when the bitmap fits in a block beside the barrier.
cudaError_t staged_path(int V, int device, bool* staged) {
  int optin = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  *staged = 4LL * bitmap_words(V) + 1024 <= optin;
  return cudaSuccess;
}

}  // namespace

extern "C" int k_reach_bitmap_words(int V) { return bitmap_words(V); }

// 1 if a search over V vertices on `device` stages its changed bitmap in
// shared memory, 0 if it reads it from device memory, -1 on an error.
extern "C" int k_reach_search_staged(int V, int device) {
  bool staged = false;
  return staged_path(V, device, &staged) == cudaSuccess ? static_cast<int>(staged) : -1;
}

// One search on `stream` of card `device`. row_ptr: [V + 1] int32; src: the
// sources in target order; u, v: [B] int32; m, out: [B] bool (one byte
// each); fronts: [2, V, W] int32 and bitmaps: [6, k_reach_bitmap_words(V)]
// int32, all zero (and left all zero); W = B / 32. The changed bitmap is
// staged in shared memory where it fits, unless `device_bitmap` is non-zero
// (a measurement of the other path). Returns the launch's error code (0
// when it was accepted).
extern "C" int k_reach_search_launch(const void* row_ptr, const void* src, const void* u,
                                     const void* v, const void* m, void* fronts, void* bitmaps,
                                     void* out, int V, int W, int k, int device_bitmap,
                                     int device, void* stream) {
  if (V <= 0 || W <= 0 || k < 0 || device < 0 || W > INT_MAX / 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = select_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  bool staged = false;
  e = staged_path(V, device, &staged);
  if (e != cudaSuccess) return static_cast<int>(e);
  staged = staged && !device_bitmap;
  SearchArgs a;
  const int words = bitmap_words(V);
  a.row_ptr = static_cast<const int*>(row_ptr);
  a.src = static_cast<const int*>(src);
  a.u = static_cast<const int*>(u);
  a.v = static_cast<const int*>(v);
  a.m = static_cast<const unsigned char*>(m);
  a.front0 = static_cast<int*>(fronts);
  a.front1 = a.front0 + static_cast<size_t>(V) * W;
  a.bits = static_cast<unsigned*>(bitmaps);
  a.out = static_cast<unsigned char*>(out);
  a.V = V;
  a.W = W;
  a.B = 32 * W;
  a.k = k;
  a.bitmap_words = words;
  // int4 moves where a row is whole 16-byte vectors; lanes a target: the
  // least power of two >= min(vectors a row, 32)
  const bool vec4 = W % 4 == 0;
  a.g_log2 = lanes_log2(vec4 ? W / 4 : W);
  const void* kernel =
      staged ? (vec4 ? reinterpret_cast<const void*>(&k_reach_search<true, 4>)
                     : reinterpret_cast<const void*>(&k_reach_search<true, 1>))
             : (vec4 ? reinterpret_cast<const void*>(&k_reach_search<false, 4>)
                     : reinterpret_cast<const void*>(&k_reach_search<false, 1>));
  const size_t smem = staged ? static_cast<size_t>(words) * 4 : 0;
  if (staged) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSearchThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // no more blocks than a warp a step of targets (or a thread a query) needs
  const long long steps = (V + (32 >> a.g_log2) - 1) / (32 >> a.g_log2);
  const long long need = (std::max(steps * 32, static_cast<long long>(a.B)) +
                          kSearchThreads - 1) / kSearchThreads;
  const int blocks = static_cast<int>(std::min(static_cast<long long>(per_sm) * sms, need));
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kSearchThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

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
  const int g_log2 = lanes_log2(W);
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
