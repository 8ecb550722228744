// One window folded into the carried dense label table, for Hopper (sm_90a):
// one launch a window, nothing read back to the host.
//
// Replaces, on one card, the composition
//   label_combine(state, cc_fold(init_labels(V), src, dst, mask))
// of gelly_streaming_tpu/summaries/labels.py (cc_fold, label_combine and the
// min-label fixpoint _propagate under both), an XLA step of the JAX package,
// not a Pallas kernel: a lax.while_loop of scatter-min hooks and pointer jumps
// over the whole table. Eager torch has no device-side while, so the port's
// torch form runs two such fixpoints a window, each turn a handful of
// launches, a clone of the table and one read of the loop condition to the
// host; the second runs over 2V pointer edges whose targets are the labels
// themselves, so on a skewed stream millions of atomic mins land on the few
// addresses of the large components' labels, every turn.
//
// What it computes. labels_in (int32 [nv]) must be min-rooted:
// 0 <= labels_in[v] <= v, a forest whose roots r have labels_in[r] == r (a
// flat table, as the dense carry emits, is the case where every label is a
// root; restored, grown or converted tables need not be flat). The window's
// lanes e < n_edges with mask[e] set add the edges src[e] ~ dst[e]. The output
// is the flat table of the union graph (forest plus window): labels[v] is the
// least id of v's component, and touched = touched_in, with src[e] and dst[e]
// set for every unmasked lane. That is what the torch form's fixpoints reach,
// bit for bit, whatever order the atomics below take.
//
// The launch, on a persistent cooperative grid, in three phases split by two
// grid barriers (cooperative_groups::this_grid().sync()):
//
// 0. Copy labels_in and touched_in into the new output tensors (16-byte
//    loads and stores where every pointer is 16-byte aligned): a published
//    table is never written again. Each label is checked against the
//    min-rooted rule on the way; a label outside [0, v] traps (the launch
//    fails, as a device-side assert does), since a cycle in the forest would
//    spin the finds below forever.
// 1. Union, lock free, in the style of ECL-CC (Jaiganesh and Burtscher, HPDC
//    2018), on the output table: each unmasked lane sets both touched flags,
//    finds both roots with path halving, and hooks the larger root under the
//    smaller with atomicCAS, retrying from the value it finds when another
//    lane hooked that root first. Parents only ever point to smaller ids and
//    only roots are hooked, so no cycle can form, every pointer leads to an
//    ancestor whatever the races of the halving stores, and each set's root
//    is its least id. Once a large component has formed, most lanes find both
//    ends under one root and write nothing but their flags: only real merges
//    pay an atomic.
// 2. Compress: labels[v] = the root of v, four labels a thread with one
//    16-byte load, stored back only where one changed. A chase longer than
//    two hops halves the path it walks, each step by an atomicCAS that
//    points a label at its grandparent only while it still holds the parent
//    the chase read: the owner of a label may have stored its root there
//    meanwhile, and nothing may overwrite a root. So every store of this
//    phase leaves an ancestor, the owners' stores leave the roots, and the
//    table ends flat. Without the halving, a chain of L hooks (a path fed in
//    reverse) would cost L^2 / 2 loads; with it, the lanes walking one chain
//    shorten it for each other, as pointer jumping does.
//
// Every load of the output table goes to L2 (ld.relaxed.gpu, or ld.global.cg
// after the last barrier): the SMs' L1 caches are not coherent with each
// other's stores. The inputs, never written, go through the read-only path.
//
// What bounds it on this card. The essential traffic of a window is the
// columns and the mask (9 bytes a lane) plus the carried table read and the
// new one written (8 bytes a vertex) and the touched flags read and written
// (2 bytes a vertex): at E = 2^20 lanes over V = 2^23 ids, 93 MB, 0.028 ms at
// 3.35 TB/s. The finds' reads are dependent and random; the 32 MB output
// table fits the 50 MB L2, so they and the compress pass stay on chip once
// the copy has brought the table in, and the lanes of the whole grid keep
// enough of them in flight to hide the latency.

#include <atomic>
#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;

struct FoldArgs {
  const int* labels_in;
  const unsigned char* touched_in;
  const int* src;
  const int* dst;
  const unsigned char* mask;
  int* labels;
  unsigned char* touched;
  int n_edges;
  int nv;
  bool vec;  // every pointer 16-byte aligned: the copy and the compress in 16 bytes
};

// A parent read or written while other lanes hook and halve: coherent at the
// card's scope, never from a stale L1 line, and never merged by the compiler.
__device__ __forceinline__ int load_parent(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_parent(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The root of v, halving the path on the way: each visited vertex is
// pointed at its grandparent (an ancestor, so a racing halving or hook of
// another lane leaves every pointer valid).
__device__ __forceinline__ int find_root(int* parent, int v) {
  int p = load_parent(parent + v);
  while (p != v) {
    const int g = load_parent(parent + p);
    if (g == p) return p;
    store_parent(parent + v, g);
    v = g;
    p = load_parent(parent + v);
  }
  return v;
}

// Merge the sets of a and b: hook the larger root under the smaller. A CAS
// that fails found that root hooked by another lane; the chase resumes from
// the parent it returned.
__device__ __forceinline__ void unite(int* parent, int a, int b) {
  int ra = find_root(parent, a);
  int rb = find_root(parent, b);
  while (ra != rb) {
    const int hi = max(ra, rb), lo = min(ra, rb);
    const int seen = atomicCAS(parent + hi, hi, lo);
    if (seen == hi) return;
    const int r = find_root(parent, seen);
    if (ra == hi) ra = r; else rb = r;
  }
}

// The root of a vertex whose parent is p, for the compress phase: each
// label passed on the way that is not its own root's child is pointed at its
// grandparent by a CAS that fails where the label changed meanwhile (to its
// root, by its owner). The vertex's own label is left to its owner.
__device__ __forceinline__ int chase_root(int* parent, int p) {
  int q = load_parent(parent + p);
  while (q != p) {
    const int g = load_parent(parent + q);
    if (g == q) return q;
    atomicCAS(parent + p, q, g);
    p = g;
    q = load_parent(parent + p);
  }
  return p;
}

__device__ __forceinline__ void check_label(int label, int v) {
  if (label < 0 || label > v) __trap();
}

__global__ void __launch_bounds__(kThreads) cc_fold_window(FoldArgs a) {
  cg::grid_group grid = cg::this_grid();
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int nv = a.nv;

  // ---- 0. copy the carried table and flags into the outputs
  long long lab_done = 0, tch_done = 0;
  if (a.vec) {
    const long long n4 = nv / 4;
    const int4* in4 = reinterpret_cast<const int4*>(a.labels_in);
    int4* out4 = reinterpret_cast<int4*>(a.labels);
    for (long long i = tid; i < n4; i += stride) {
      const int4 x = __ldg(in4 + i);
      const int v = static_cast<int>(4 * i);
      check_label(x.x, v);
      check_label(x.y, v + 1);
      check_label(x.z, v + 2);
      check_label(x.w, v + 3);
      out4[i] = x;
    }
    const long long n16 = nv / 16;
    const uint4* tin = reinterpret_cast<const uint4*>(a.touched_in);
    uint4* tout = reinterpret_cast<uint4*>(a.touched);
    for (long long i = tid; i < n16; i += stride) tout[i] = __ldg(tin + i);
    lab_done = 4 * n4;
    tch_done = 16 * n16;
  }
  for (long long v = lab_done + tid; v < nv; v += stride) {
    const int x = __ldg(a.labels_in + v);
    check_label(x, static_cast<int>(v));
    a.labels[v] = x;
  }
  for (long long v = tch_done + tid; v < nv; v += stride) a.touched[v] = __ldg(a.touched_in + v);
  grid.sync();

  // ---- 1. the window's unmasked lanes: flags, then union
  for (long long e = tid; e < a.n_edges; e += stride) {
    if (!__ldg(a.mask + e)) continue;
    const int u = __ldg(a.src + e);
    const int w = __ldg(a.dst + e);
    if (static_cast<unsigned>(u) >= static_cast<unsigned>(nv) ||
        static_cast<unsigned>(w) >= static_cast<unsigned>(nv)) {
      __trap();
    }
    a.touched[u] = 1;
    a.touched[w] = 1;
    if (u != w) unite(a.labels, u, w);
  }
  grid.sync();

  // ---- 2. compress: every label to its root
  long long done = 0;
  if (a.vec) {
    const long long n4 = nv / 4;
    int4* lab4 = reinterpret_cast<int4*>(a.labels);
    for (long long i = tid; i < n4; i += stride) {
      const int4 x = __ldcg(lab4 + i);
      int r[4] = {x.x, x.y, x.z, x.w};
      bool changed = false;
      for (int j = 0; j < 4; ++j) {
        const int v = static_cast<int>(4 * i) + j;
        if (r[j] == v) continue;
        const int p = chase_root(a.labels, r[j]);
        changed |= p != r[j];
        r[j] = p;
      }
      if (changed) __stcg(lab4 + i, make_int4(r[0], r[1], r[2], r[3]));
    }
    done = 4 * n4;
  }
  for (long long v = done + tid; v < nv; v += stride) {
    const int first = load_parent(a.labels + v);
    if (first == v) continue;
    const int p = chase_root(a.labels, first);
    if (p != first) store_parent(a.labels + v, p);
  }
}

// ---------------------------------------------------------------- launching
// The most blocks of the cooperative grid on each card: 0 until read.
std::atomic<int> g_max_blocks[kMaxDevices];

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// One window folded into the carried table on `stream` of card `device`.
// labels_in: [nv] int32, min-rooted; touched_in: [nv] bool (one byte each);
// src, dst: [n_edges] int32, each unmasked id below nv; mask: [n_edges] bool;
// labels_out: [nv] int32; touched_out: [nv] bool; the outputs distinct from
// every input. Returns the launch's error code (0 when it was accepted).
extern "C" int cc_fold_launch(const void* labels_in, const void* touched_in, const void* src,
                              const void* dst, const void* mask, void* labels_out,
                              void* touched_out, long long n_edges, int nv, int device,
                              void* stream) {
  if (n_edges < 0 || n_edges > INT_MAX || nv < 1 || device < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = select_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int most = 0;
  e = cooperative_blocks(reinterpret_cast<const void*>(cc_fold_window), kThreads, 0, device,
                         g_max_blocks, &most);
  if (e != cudaSuccess) return static_cast<int>(e);
  FoldArgs a;
  a.labels_in = static_cast<const int*>(labels_in);
  a.touched_in = static_cast<const unsigned char*>(touched_in);
  a.src = static_cast<const int*>(src);
  a.dst = static_cast<const int*>(dst);
  a.mask = static_cast<const unsigned char*>(mask);
  a.labels = static_cast<int*>(labels_out);
  a.touched = static_cast<unsigned char*>(touched_out);
  a.n_edges = static_cast<int>(n_edges);
  a.nv = nv;
  a.vec = aligned16(labels_in) && aligned16(touched_in) && aligned16(labels_out) &&
          aligned16(touched_out);
  // no more threads than a lane or four labels need
  const long long work = n_edges > nv / 4 ? n_edges : nv / 4 + 1;
  const long long need = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < most ? need : most);
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(cc_fold_window), dim3(blocks),
                                  dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
