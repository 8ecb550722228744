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
// gives the same value as the reference's per-edge division. The scatter is a
// float atomicAdd an edge, as the reference's .at[dst].add and the port's
// index_add_ on a card: the order of the sums changes from run to run, so
// ranks are compared within a tolerance, never bit for bit.
//
// What bounds it. An iteration moves the edge columns (8 bytes an edge), one
// gather and one atomic an edge, and about 20 bytes a vertex; at config #4's
// 2^20 edges that is about 10 MB, which stays in the 50 MB L2 from one
// iteration to the next. So the iterations are bound by the L2's atomics and
// the gathers' latency, and by the two grid-wide barriers an iteration, not by
// device memory. Hot targets serialize their atomics in L2.
//
// The launch, phases split by cooperative_groups::this_grid().sync():
//
// 0. zero the degrees, the accumulator and the reduction slots;
// 1. out-degrees by atomicAdd over src; the warm start's fill into r_out and
//    its sum;
// 2. the renormalization, each vertex's contribution r / max(deg, 1), and the
//    first iteration's dangling mass;
// 3. per iteration i: (a) acc[dst] += contrib[src] an edge; barrier; (b) each
//    vertex's new rank, its contribution, its |new - r| into l1 slot i % 3 and
//    (where it dangles) its mass into dangling slot (i + 1) % 3 for the next
//    iteration, acc zeroed for the next iteration; barrier; every thread reads
//    l1 slot i % 3, so all stop at the same iteration. Each kind of slot has
//    three: phase (a) of iteration i zeroes l1 slot (i + 1) % 3, last read
//    after the barrier that ended iteration i - 2, and dangling slot
//    (i + 2) % 3, last read in phase (b) of iteration i - 1; so no slot is
//    zeroed while a block may still read it. A block sums its threads' parts
//    (warp shuffles, then shared memory) and adds one atomic a slot.
//
// Values that the launch writes are read back with plain loads, never __ldg
// (the non-coherent path), and the slots with __ldcg (from L2).

#include <algorithm>
#include <atomic>
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
// reduction slots of each kind: iteration i sums into slot i % kSlots
constexpr int kSlots = 3;
// the scratch's floats past its three vertex arrays: kSlots of l1, kSlots of
// dangling mass, the warm start's sum
constexpr int kSlotFloats = 2 * kSlots + 2;

struct Args {
  const int* src;         // [E]
  const int* dst;         // [E]
  const float* ranks_in;  // [nv], before the warm start; not written
  float* ranks;           // [nv], the iterate, returned
  float* contrib;         // [nv], r / max(deg, 1)
  float* acc;             // [nv], the scatter's sums, zero between iterations
  unsigned* deg;          // [nv], out-degrees
  float* slots;           // [kSlotFloats]
  float* delta_out;       // the last iteration's l1
  int* iters_out;         // the iterations run
  long long E;
  int nv, n_seen, max_iters;
  float damping, tol;
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  return x;
}

// The block's sums of a and b, in thread 0. Every thread of the block calls
// it, so every shuffle runs with the whole warp.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 part[kThreads / 32];
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = make_float2(a, b);
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  if (warp == 0) {
    s = lane < kThreads / 32 ? part[lane] : make_float2(0.f, 0.f);
    s.x = warp_sum(s.x);
    s.y = warp_sum(s.y);
  }
  __syncthreads();  // part is written again by the next call
  return s;
}

__global__ void __launch_bounds__(kThreads) pagerank_fixpoint(Args a) {
  cg::grid_group grid = cg::this_grid();
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  float* l1 = a.slots;
  float* dm = a.slots + kSlots;
  float* total = a.slots + 2 * kSlots;
  const int nv = a.nv, n_seen = a.n_seen;
  const float n = static_cast<float>(max(n_seen, 1));
  const float d = a.damping;
  const float teleport = __fdiv_rn(__fsub_rn(1.0f, d), n);

  // 0. zero
  for (long long v = tid; v < nv; v += nthreads) {
    a.deg[v] = 0u;
    a.acc[v] = 0.f;
  }
  if (tid < kSlotFloats) a.slots[tid] = 0.f;
  grid.sync();

  // 1. out-degrees; the warm start's fill and its sum
  for (long long e = tid; e < a.E; e += nthreads) atomicAdd(a.deg + __ldg(a.src + e), 1u);
  float part = 0.f;
  for (long long v = tid; v < nv; v += nthreads) {
    float x = __ldg(a.ranks_in + v);
    if (v < n_seen && x == 0.f) x = __fdiv_rn(1.0f, n);
    a.ranks[v] = x;
    part += x;
  }
  float2 s = block_sum2(part, 0.f);
  if (threadIdx.x == 0) atomicAdd(total, s.x);
  grid.sync();

  // 2. renormalize; contributions; the first iteration's dangling mass
  const float norm = fmaxf(__ldcg(total), 1e-30f);
  part = 0.f;
  for (long long v = tid; v < nv; v += nthreads) {
    const float x = __fdiv_rn(a.ranks[v], norm);
    const unsigned k = a.deg[v];
    a.ranks[v] = x;
    a.contrib[v] = __fdiv_rn(x, fmaxf(static_cast<float>(k), 1.0f));
    if (v < n_seen && k == 0u) part += x;
  }
  s = block_sum2(part, 0.f);
  if (threadIdx.x == 0) atomicAdd(dm, s.x);
  grid.sync();

  // 3. the iterations
  float delta = __int_as_float(0x7f800000);  // +inf, as before any iteration
  int it = 0;
  while (it < a.max_iters) {
    const int cur = it % kSlots, nxt = (it + 1) % kSlots;
    // (a) the scatter, four edges in flight a thread
    if (tid == 0) {
      l1[nxt] = 0.f;
      dm[(it + 2) % kSlots] = 0.f;
    }
    long long e = tid;
    for (; e + 3 * nthreads < a.E; e += 4 * nthreads) {
      int s4[4], t4[4];
      float c4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s4[j] = __ldg(a.src + e + j * nthreads);
        t4[j] = __ldg(a.dst + e + j * nthreads);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) c4[j] = a.contrib[s4[j]];
#pragma unroll
      for (int j = 0; j < 4; ++j) atomicAdd(a.acc + t4[j], c4[j]);
    }
    for (; e < a.E; e += nthreads) atomicAdd(a.acc + __ldg(a.dst + e), a.contrib[__ldg(a.src + e)]);
    grid.sync();

    // (b) the new ranks, their L1 change and the next dangling mass
    const float dterm = __fdiv_rn(__ldcg(dm + cur), n);
    float lpart = 0.f, dnext = 0.f;
    for (long long v = tid; v < nv; v += nthreads) {
      const float r = a.ranks[v];
      const float sum = a.acc[v];
      a.acc[v] = 0.f;
      float x = 0.f;
      if (v < n_seen) x = __fadd_rn(teleport, __fmul_rn(d, __fadd_rn(sum, dterm)));
      lpart += fabsf(x - r);
      const unsigned k = a.deg[v];
      a.ranks[v] = x;
      a.contrib[v] = __fdiv_rn(x, fmaxf(static_cast<float>(k), 1.0f));
      if (v < n_seen && k == 0u) dnext += x;
    }
    s = block_sum2(lpart, dnext);
    if (threadIdx.x == 0) {
      atomicAdd(l1 + cur, s.x);
      atomicAdd(dm + nxt, s.y);
    }
    grid.sync();
    delta = __ldcg(l1 + cur);
    ++it;
    if (delta <= a.tol) break;
  }
  if (tid == 0) {
    *a.delta_out = delta;
    *a.iters_out = it;
  }
}

// The cooperative grid's most blocks on each card (blocks an SM times SMs),
// read once a card: 0 until then.
constexpr int kMaxDevices = 64;
std::atomic<int> g_max_blocks[kMaxDevices];

cudaError_t max_blocks(int device, int* out) {
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  int blocks = g_max_blocks[device].load(std::memory_order_relaxed);
  if (blocks == 0) {
    const void* kernel = reinterpret_cast<const void*>(&pagerank_fixpoint);
    int per_sm = 0, sms = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    blocks = per_sm * sms;
    g_max_blocks[device].store(blocks, std::memory_order_relaxed);
  }
  *out = blocks;
  return cudaSuccess;
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

extern "C" int pagerank_slot_floats() { return kSlotFloats; }

// One window's warm start and fixpoint on `stream` of card `device`. src,
// dst: [n_edges] int32, every id below nv; ranks_in: [nv] float32 (read
// only); ranks_out: [nv] float32; scratch: 3 * nv + pagerank_slot_floats()
// float32, any contents; delta: one float32; iters: one int32. Returns the
// launch's error code (0 when it was accepted).
extern "C" int pagerank_fixpoint_launch(const void* src, const void* dst, const void* ranks_in,
                                        void* ranks_out, void* scratch, void* delta, void* iters,
                                        long long n_edges, int nv, int n_seen, float damping,
                                        float tol, int max_iters, int device, void* stream) {
  if (n_edges < 0 || n_edges > INT_MAX || nv < 0 || n_seen < 0 || max_iters < 0 || device < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = select_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a;
  float* f = static_cast<float*>(scratch);
  const size_t v = static_cast<size_t>(nv);
  a.src = static_cast<const int*>(src);
  a.dst = static_cast<const int*>(dst);
  a.ranks_in = static_cast<const float*>(ranks_in);
  a.ranks = static_cast<float*>(ranks_out);
  a.contrib = f;
  a.acc = f + v;
  a.deg = reinterpret_cast<unsigned*>(f + 2 * v);
  a.slots = f + 3 * v;
  a.delta_out = static_cast<float*>(delta);
  a.iters_out = static_cast<int*>(iters);
  a.E = n_edges;
  a.nv = nv;
  a.n_seen = n_seen;
  a.max_iters = max_iters;
  a.damping = damping;
  a.tol = tol;
  int most = 0;
  e = max_blocks(device, &most);
  if (e != cudaSuccess) return static_cast<int>(e);
  // no more blocks than a thread an edge (or a vertex) needs
  const long long need =
      (std::max({n_edges, static_cast<long long>(nv), 1LL}) + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(std::min(static_cast<long long>(most), need));
  const void* kernel = reinterpret_cast<const void*>(&pagerank_fixpoint);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pagerank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
