// PageRank's window fixpoint, for Hopper (sm_90a): one launch a window.
//
// Replaces the warm start and the fixpoint of
// gelly_streaming_tpu/library/pagerank.py:_make_pr_window_body (the warm start
// at :146-152, fixpoint at :89-136), an XLA step of the JAX package, not a
// Pallas kernel. The reference runs the whole window as one device program:
// its early exit is a lax.while_loop over chunk-long lax.scan bodies, so no
// value goes back to the host between iterations. Eager torch has no
// device-side while: the port's torch form enqueued about 11 launches an
// iteration and read a flag on the host once a chunk, and its host spent
// several times the card's time enqueueing them. This launch runs the loop on
// the card, on a persistent cooperative grid, and reads nothing back.
//
// What it computes, over the edges src[e] -> dst[e] (e < E), nv rank slots,
// the seen vertices v < n_seen ("active") and n = max(n_seen, 1) as a float:
//
//   warm start: r[v] = 1/n where v is active and r_in[v] == 0, else r_in[v];
//               then r /= max(sum(r), 1e-30)
//   deg[v]    = the out-degree of v; dangling = active and deg == 0
//   iterate:  acc[t] = sum over edges s -> t of r[s] / max(deg[s], 1)
//             new[v] = (1 - d)/n + d * (acc[v] + dangling mass / n) if active,
//                      else 0
//             l1 = sum |new - r|; r = new; stop once l1 <= tol, or after
//             max_iters iterations
//
// It returns the last r (into a new tensor: the input ranks are never
// written), that iteration's l1 and the iterations run, the converged one
// included. The reference's freeze flag computes up to chunk - 1 iterations
// past convergence and throws their results away (ranks, l1 and count stay
// frozen at the converged iteration); stopping there gives the same ranks,
// l1_delta and iterations, so this loop has no chunks.
//
// The arithmetic is the reference's: a float32 1 - d, a division by the
// out-degree, teleport + d * (acc + dangling / n) rounded after each
// operation (__fmul_rn and __fadd_rn keep nvcc from contracting it into an
// fma, which the torch form never does). r[s] / max(deg[s], 1) is divided
// once a vertex in the phase that writes r[s] and gathered per edge, which
// gives the same value as the reference's per-edge division.
//
// The kernel PULLS: it builds a CSR of the window's edges by target once,
// inside the launch, and sums each vertex's in-edges where its new rank is
// computed.
//
// What bounds it on this card. Config #4's last window (E = 2^20 over 2^18
// ids, in-degrees at most 31, 4.8 on average over the non-empty rows) stays in
// the 50 MB L2 from one iteration to the next: an iteration is bound by L2
// traffic and latency and by its grid barriers, not by device memory. At the
// scale pass's last window (E = 2^23 over 2^21 ids, an R-MAT graph) the
// columns (64 MB) no longer fit in L2 and the in-degrees are skewed: the
// largest is 26,614, rows of 256 or more hold 2.9 M of the 8.4 M edges.
//
// Why it pulls. A push (a float atomicAdd an edge into an accumulator every
// iteration) moves 8 bytes of edge columns, a gather and a float atomic an
// edge, and crosses two barriers an iteration (the scatter must finish before
// a rank is computed); at a hub its atomics serialize in the hub's L2 slice,
// every iteration. The pull spends two integer-atomic passes over the edges
// and a scan once a window, then reads 4 bytes of sources and gathers one
// contribution an edge an iteration, with no float atomic, and crosses one
// barrier an iteration, because a vertex's sum is finished where its new rank
// is computed. On an H100 at 700 W the push took 0.480 ms at config #4's last
// window and 6.27 ms at the scale pass's, the pull 0.336 and 4.02.
//
// The pull's work split. A row (a target's in-edges) of at most kRowThread
// entries is summed by one thread, in a grid-stride loop over the vertices.
// A longer row of a seen vertex is cut into pieces of at most kPiece entries,
// each summed by one warp (lane l takes entries l, l + 32, ...), so a lane
// sums at most kPiece / 32 = kRowThread entries either way and no warp sums
// much more than another; the rows of the light loop are at most kRowThread
// long. kPiece = 1024 cuts the 26,614-entry hub into 26 pieces and a hub of
// 2^16 into 64, so its sum spreads over as many warps, while a row of 33 to
// 1024 entries is one piece, whose warp writes the vertex's update itself. A
// row of several pieces is finished by the last of its pieces to arrive: each
// writes its partial sum, fences (__threadfence) and adds one to the row's
// arrival counter; the one that reads count - 1 back fences again, sums the
// partials in piece order, writes the update and sets the counter to 0 for
// the next iteration (whose increments follow the grid barrier).
//
// The pull, phases split by cooperative_groups::this_grid().sync():
//
// A. zero the out- and in-degree counts;
// B. both counts by integer atomics over the edges, each edge's place in its
//    target's row kept (the value its in-degree atomic returned); the warm
//    start's fill into r and each block's part of its sum;
// C. the renormalization (every block sums the blocks' parts in one order),
//    each vertex's contribution into buffer 0, the first iteration's dangling
//    mass; each block's count of entries and pieces over its range of
//    vertices;
// D. each block's offsets (the counts of the blocks before it), a block scan,
//    then row_ptr, the piece list in vertex order and the arrival counters at
//    0;
// E. each source into col at its target's row_ptr plus its place (the
//    atomics of B order a row's sources differently from run to run, so the
//    sums do too);
// then per iteration i, one pass over the pieces and the rows and one barrier.
// The contributions are double-buffered: iteration i gathers from buffer
// i % 2 and writes buffer (i + 1) % 2, which no one reads before the barrier
// (its last reader was iteration i - 1, before the barrier that ended it).
// Each block writes its sums of |new - r| and of the next dangling mass into
// its own entry of slot i % 2 (a plain store, no float atomic); after the
// barrier every block sums slot i % 2 over the blocks in one fixed order, so
// every thread gets the same l1 bit for bit and all stop at the same
// iteration. Slot i % 2 is read only between the barrier ending iteration i
// and the one ending i + 1; its next writer is iteration i + 2, after that
// barrier, so two slots suffice (one would let a fast block of iteration
// i + 1 overwrite a sum that a slow block still reads). Set-up writes the first
// iteration's dangling mass into slot 1, which iteration 1 writes again only
// after the barrier that ends iteration 0.
//
// Loads. src, dst and ranks_in, never written, go through __ldg. What the
// launch writes and later rewrites (the ranks, the contributions, the
// in-degrees, the partials, the blocks' slots) is read with __ldcg, from L2,
// past the SM's L1, which is not coherent with other SMs' writes. What the
// set-up writes once and the iterations only read (the out-degrees, row_ptr,
// col, the piece list) goes through __ldca, cached in L1: no SM reads those
// lines before the barrier that ends their writing, so no L1 holds a stale
// copy, and a thread's consecutive entries of col cost one L2 request, not
// one each.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- the pull
// a row of at most kRowThread entries is summed by one thread
constexpr int kRowThread = 32;
// a longer row is cut into pieces of at most kPiece entries, a warp each
constexpr int kPiece = 1024;
// the blocks' slots have room for this many blocks; the grid is no larger
constexpr int kMaxGrid = 2048;

struct PullArgs {
  const int* src;         // [E]
  const int* dst;         // [E]
  const float* ranks_in;  // [nv], before the warm start; not written
  float* ranks;           // [nv], the iterate, returned
  float* contrib;         // [2 * nv], r / max(deg, 1), double-buffered
  unsigned* deg;          // [nv], out-degrees
  int* indeg;             // [nv], in-degrees
  int* row_ptr;           // [nv + 1]
  int* place;             // [E], each edge's place in its target's row
  int* col;               // [E], the sources grouped by target
  int* piece_row;         // [max_pieces], the vertex of each piece
  int* piece_start;       // [max_pieces], its first entry in col
  int* arrive;            // [max_pieces], at a row's first piece: arrivals
  float* partial;         // [max_pieces], each piece's sum
  float* b_total;         // [kMaxGrid], the warm start's sum, by block
  int* b_entries;         // [kMaxGrid], col entries of the block's vertices
  int* b_pieces;          // [kMaxGrid], pieces of the block's vertices
  float* b_l1;            // [2 * kMaxGrid], slot i % 2 of iteration i
  float* b_dm;            // [2 * kMaxGrid], the next dangling mass, likewise
  float* delta_out;       // the last iteration's l1
  int* iters_out;         // the iterations run
  int E, nv, n_seen, max_iters;
  float damping, tol;
};

// The bound on the pieces of E entries: a piece belongs to a row of more
// than kRowThread entries (at most E / (kRowThread + 1) rows), which has one
// piece for each kPiece entries or part of them.
long long max_pieces(long long n_edges) {
  return n_edges / (kRowThread + 1) + n_edges / kPiece + 1;
}

// The pull's scratch, in 4-byte words, in PullArgs' order.
long long scratch_words(long long n_edges, long long nv) {
  return 5 * nv + 1 + 2 * n_edges + 4 * max_pieces(n_edges) + 7LL * kMaxGrid;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  return x;
}

// The sum in every lane: each lane adds the same two values at each step
// (a + b and b + a round alike), so every lane ends with the same bits.
__device__ __forceinline__ float warp_all_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// The block's sums of a and b in every thread, in one fixed order (so two
// blocks given the same values get the same bits). Every thread calls it.
__device__ __forceinline__ float2 block_all_sum2(float a, float b) {
  __shared__ float2 part[kWarps];
  a = warp_all_sum(a);
  b = warp_all_sum(b);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    s.x += part[w].x;
    s.y += part[w].y;
  }
  __syncthreads();  // part is written again by the next call
  return s;
}

// The sums over the grid's blocks of a[k] and b[k], k < gridDim.x, in every
// thread, the same in every block.
__device__ __forceinline__ float2 grid_all_sum2(const float* a, const float* b) {
  float x = 0.f, y = 0.f;
  for (int k = threadIdx.x; k < static_cast<int>(gridDim.x); k += kThreads) {
    x += __ldcg(a + k);
    y += __ldcg(b + k);
  }
  return block_all_sum2(x, y);
}

// The block's exclusive prefix of x (two int counts) in thread order, and
// its total in *all. Every thread calls it.
__device__ __forceinline__ int2 block_scan2(int2 x, int2* all) {
  __shared__ int2 part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(kFull, inc.x, o), b = __shfl_up_sync(kFull, inc.y, o);
    if (lane >= o) {
      inc.x += a;
      inc.y += b;
    }
  }
  if (lane == 31) part[warp] = inc;
  __syncthreads();
  int2 before = make_int2(0, 0), total = make_int2(0, 0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      before.x += part[w].x;
      before.y += part[w].y;
    }
    total.x += part[w].x;
    total.y += part[w].y;
  }
  __syncthreads();
  *all = total;
  return make_int2(before.x + inc.x - x.x, before.y + inc.y - x.y);
}

// The pieces of a row of `in` entries of vertex v: none where a thread sums
// it (or where v is not seen: its new rank is 0 whatever it receives).
__device__ __forceinline__ int pieces_of(int in, long long v, int n_seen) {
  return v < n_seen && in > kRowThread ? (in + kPiece - 1) / kPiece : 0;
}

// The sum of cur[col[j]] over j in [lo, hi) by one lane, `step` apart, in
// order; four gathers in flight.
__device__ __forceinline__ float gather_sum(const float* cur, const int* col, long long lo,
                                            long long hi, int step) {
  float s = 0.f;
  long long j = lo;
  for (; j + 3 * step < hi; j += 4 * step) {
    int c[4];
    float x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = __ldca(col + j + k * step);
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = __ldcg(cur + c[k]);
#pragma unroll
    for (int k = 0; k < 4; ++k) s += x[k];
  }
  for (; j < hi; j += step) s += __ldcg(cur + __ldca(col + j));
  return s;
}

// A thread's contiguous share of the block's contiguous range of vertices
// (set-up phases C and D, so that a block's vertices are its scan's).
__device__ __forceinline__ long long lmin(long long x, long long y) { return x < y ? x : y; }

__device__ __forceinline__ void my_vertices(int nv, long long* lo, long long* hi) {
  const long long per_block = (static_cast<long long>(nv) + gridDim.x - 1) / gridDim.x;
  const long long b0 = blockIdx.x * per_block;
  const long long b1 = lmin(nv, b0 + per_block);
  const long long per_thread = (per_block + kThreads - 1) / kThreads;
  *lo = lmin(b1, b0 + threadIdx.x * per_thread);
  *hi = lmin(b1, *lo + per_thread);
}

__global__ void __launch_bounds__(kThreads) pagerank_fixpoint(PullArgs a) {
  cg::grid_group grid = cg::this_grid();
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long gwarp = tid >> 5, nwarps = nthreads >> 5;
  const int lane = threadIdx.x & 31;
  const int nv = a.nv, n_seen = a.n_seen;
  const float n = static_cast<float>(max(n_seen, 1));
  const float d = a.damping;
  const float teleport = __fdiv_rn(__fsub_rn(1.0f, d), n);

  // A. zero the counts
  for (long long v = tid; v < nv; v += nthreads) {
    a.deg[v] = 0u;
    a.indeg[v] = 0;
  }
  grid.sync();

  // B. out- and in-degrees and the edges' places; the warm start's fill and
  // its sum. Four places in flight a thread.
  long long e = tid;
  for (; e + 3 * nthreads < a.E; e += 4 * nthreads) {
    int at4[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      atomicAdd(a.deg + __ldg(a.src + e + k * nthreads), 1u);
      at4[k] = atomicAdd(a.indeg + __ldg(a.dst + e + k * nthreads), 1);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) a.place[e + k * nthreads] = at4[k];
  }
  for (; e < a.E; e += nthreads) {
    atomicAdd(a.deg + __ldg(a.src + e), 1u);
    a.place[e] = atomicAdd(a.indeg + __ldg(a.dst + e), 1);
  }
  float part = 0.f;
  for (long long v = tid; v < nv; v += nthreads) {
    float x = __ldg(a.ranks_in + v);
    if (v < n_seen && x == 0.f) x = __fdiv_rn(1.0f, n);
    a.ranks[v] = x;
    part += x;
  }
  float2 s = block_all_sum2(part, 0.f);
  if (threadIdx.x == 0) a.b_total[blockIdx.x] = s.x;
  grid.sync();

  // C. renormalize, contributions, the first dangling mass; the block's
  // entries and pieces
  long long lo, hi;
  my_vertices(nv, &lo, &hi);
  const float norm = fmaxf(grid_all_sum2(a.b_total, a.b_total).x, 1e-30f);
  part = 0.f;
  int2 mine = make_int2(0, 0);
  for (long long v = lo; v < hi; ++v) {
    const float x = __fdiv_rn(__ldcg(a.ranks + v), norm);
    const unsigned k = __ldcg(a.deg + v);
    a.ranks[v] = x;
    a.contrib[v] = __fdiv_rn(x, fmaxf(static_cast<float>(k), 1.0f));
    if (v < n_seen && k == 0u) part += x;
    const int in = __ldcg(a.indeg + v);
    mine.x += in;
    mine.y += pieces_of(in, v, n_seen);
  }
  s = block_all_sum2(part, 0.f);
  int2 block;
  block_scan2(mine, &block);
  if (threadIdx.x == 0) {
    a.b_dm[kMaxGrid + blockIdx.x] = s.x;  // slot 1: read by iteration 0
    a.b_entries[blockIdx.x] = block.x;
    a.b_pieces[blockIdx.x] = block.y;
  }
  grid.sync();

  // D. row_ptr, the piece list
  int2 before = make_int2(0, 0);
  for (int k = threadIdx.x; k < static_cast<int>(blockIdx.x); k += kThreads) {
    before.x += __ldcg(a.b_entries + k);
    before.y += __ldcg(a.b_pieces + k);
  }
  int2 offset;
  block_scan2(before, &offset);  // the counts of the blocks before this one
  int n_pieces = 0;
  for (int k = threadIdx.x; k < static_cast<int>(gridDim.x); k += kThreads) {
    n_pieces += __ldcg(a.b_pieces + k);
  }
  int2 total;
  block_scan2(make_int2(n_pieces, 0), &total);
  n_pieces = total.x;
  int2 at = block_scan2(mine, &total);
  int entry = offset.x + at.x, piece = offset.y + at.y;
  for (long long v = lo; v < hi; ++v) {
    const int in = __ldcg(a.indeg + v);
    a.row_ptr[v] = entry;
    const int np = pieces_of(in, v, n_seen);
    for (int j = 0; j < np; ++j) {
      a.piece_row[piece + j] = static_cast<int>(v);
      a.piece_start[piece + j] = entry + j * kPiece;
    }
    if (np > 1) a.arrive[piece] = 0;
    entry += in;
    piece += np;
  }
  if (tid == 0) a.row_ptr[nv] = a.E;
  grid.sync();

  // E. the sources into col, grouped by target
  for (e = tid; e < a.E; e += nthreads) {
    a.col[__ldca(a.row_ptr + __ldg(a.dst + e)) + __ldcg(a.place + e)] = __ldg(a.src + e);
  }
  grid.sync();

  // the iterations
  float dm = grid_all_sum2(a.b_dm + kMaxGrid, a.b_dm + kMaxGrid).x;
  float delta = __int_as_float(0x7f800000);  // +inf, as before any iteration
  int it = 0;
  while (it < a.max_iters) {
    const int slot = it & 1;
    const float* cur = a.contrib + static_cast<long long>(slot) * nv;
    float* nxt = a.contrib + static_cast<long long>(slot ^ 1) * nv;
    const float dterm = __fdiv_rn(dm, n);
    float lpart = 0.f, dnext = 0.f;
    // vertex v's new rank from its sum: its l1 part, its contribution and
    // (where it dangles) its mass for the next iteration
    auto update = [&](long long v, float sum) {
      const float r = __ldcg(a.ranks + v);
      float x = 0.f;
      if (v < n_seen) x = __fadd_rn(teleport, __fmul_rn(d, __fadd_rn(sum, dterm)));
      lpart += fabsf(x - r);
      const unsigned k = __ldca(a.deg + v);
      a.ranks[v] = x;
      nxt[v] = __fdiv_rn(x, fmaxf(static_cast<float>(k), 1.0f));
      if (v < n_seen && k == 0u) dnext += x;
    };
    // the pieces, a warp each (the loop runs in step across the warp)
    for (long long p = gwarp; p < n_pieces; p += nwarps) {
      const int v = __ldca(a.piece_row + p);
      const int start = __ldca(a.piece_start + p);
      const int rs = __ldca(a.row_ptr + v), re = __ldca(a.row_ptr + v + 1);
      const int end = start + min(kPiece, re - start);
      const float sum = warp_sum(gather_sum(cur, a.col, start + lane, end, 32));
      if (lane == 0) {
        if (re - rs <= kPiece) {
          update(v, sum);
        } else {
          a.partial[p] = sum;
          __threadfence();
          const long long first = p - (start - rs) / kPiece;
          const int np = (re - rs + kPiece - 1) / kPiece;
          if (atomicAdd(a.arrive + first, 1) == np - 1) {
            __threadfence();
            float total_sum = 0.f;
            for (int q = 0; q < np; ++q) total_sum += __ldcg(a.partial + first + q);
            a.arrive[first] = 0;
            update(v, total_sum);
          }
        }
      }
    }
    // the rows a thread sums, and the vertices no one sends to
    for (long long v = tid; v < nv; v += nthreads) {
      const int rs = __ldca(a.row_ptr + v), re = __ldca(a.row_ptr + v + 1);
      const bool seen = v < n_seen;
      if (seen && re - rs > kRowThread) continue;  // its pieces' warps update it
      update(v, seen ? gather_sum(cur, a.col, rs, re, 1) : 0.f);
    }
    s = block_all_sum2(lpart, dnext);
    if (threadIdx.x == 0) {
      a.b_l1[slot * kMaxGrid + blockIdx.x] = s.x;
      a.b_dm[slot * kMaxGrid + blockIdx.x] = s.y;
    }
    grid.sync();
    s = grid_all_sum2(a.b_l1 + slot * kMaxGrid, a.b_dm + slot * kMaxGrid);
    delta = s.x;
    dm = s.y;
    ++it;
    if (delta <= a.tol) break;
  }
  if (tid == 0) {
    *a.delta_out = delta;
    *a.iters_out = it;
  }
}

// ---------------------------------------------------------------- launching
// The most blocks of the cooperative grid on each card: 0 until read.
std::atomic<int> g_max_blocks[kMaxDevices];

}  // namespace

// The pull's scratch in bytes for n_edges edges and nv rank slots.
extern "C" long long pagerank_scratch_bytes(long long n_edges, int nv) {
  return 4 * scratch_words(n_edges, nv);
}

// One window's warm start and fixpoint on `stream` of card `device`, pulled
// over a CSR by target. src, dst: [n_edges] int32, every id below nv;
// ranks_in: [nv] float32 (read only); ranks_out: [nv] float32; scratch:
// pagerank_scratch_bytes(n_edges, nv) bytes, 4-byte aligned, any contents;
// delta: one float32; iters: one int32. Returns the launch's error code (0
// when it was accepted).
extern "C" int pagerank_fixpoint_launch(const void* src, const void* dst, const void* ranks_in,
                                        void* ranks_out, void* scratch, void* delta, void* iters,
                                        long long n_edges, int nv, int n_seen, float damping,
                                        float tol, int max_iters, int device, void* stream) {
  if (n_edges < 0 || n_edges > INT_MAX || nv < 0 || nv == INT_MAX || n_seen < 0 ||
      max_iters < 0 || device < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = select_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long v = nv, mp = max_pieces(n_edges);
  float* f = static_cast<float*>(scratch);
  int* w = static_cast<int*>(scratch);
  PullArgs a;
  a.src = static_cast<const int*>(src);
  a.dst = static_cast<const int*>(dst);
  a.ranks_in = static_cast<const float*>(ranks_in);
  a.ranks = static_cast<float*>(ranks_out);
  a.contrib = f;
  a.deg = reinterpret_cast<unsigned*>(w + 2 * v);
  a.indeg = w + 3 * v;
  a.row_ptr = w + 4 * v;
  a.place = w + 5 * v + 1;
  a.col = a.place + n_edges;
  a.piece_row = a.col + n_edges;
  a.piece_start = a.piece_row + mp;
  a.arrive = a.piece_start + mp;
  a.partial = reinterpret_cast<float*>(a.arrive + mp);
  a.b_total = a.partial + mp;
  a.b_entries = reinterpret_cast<int*>(a.b_total + kMaxGrid);
  a.b_pieces = a.b_entries + kMaxGrid;
  a.b_l1 = reinterpret_cast<float*>(a.b_pieces + kMaxGrid);
  a.b_dm = a.b_l1 + 2 * kMaxGrid;
  a.delta_out = static_cast<float*>(delta);
  a.iters_out = static_cast<int*>(iters);
  a.E = static_cast<int>(n_edges);
  a.nv = nv;
  a.n_seen = n_seen;
  a.max_iters = max_iters;
  a.damping = damping;
  a.tol = tol;
  const void* kernel = reinterpret_cast<const void*>(&pagerank_fixpoint);
  int most = 0;
  e = cooperative_blocks(kernel, kThreads, 0, device, g_max_blocks, &most);
  if (e != cudaSuccess) return static_cast<int>(e);
  // at most kMaxGrid blocks (the blocks' slots) and no more than a thread an
  // edge (or a vertex) needs
  const long long need =
      (std::max({n_edges, static_cast<long long>(nv), 1LL}) + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(std::min({static_cast<long long>(most), need,
                                                 static_cast<long long>(kMaxGrid)}));
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), params, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
