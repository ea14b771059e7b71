// Delta-stepping's settle step over on-card near/far queues (the
// near-far worklist of Davidson, Baxter, Garland and Owens, IPDPS 2014):
// the card path of SSSP's `frontier` engine.  Three kernels over one
// resident state:
//   sssp_frontier_reset    a run's start: every distance f32::MAX but the
//                          source's 0, the stamps and far marks cleared,
//                          the source alone in the first near queue;
//   sssp_frontier_relax    one settle step: relax the out-arcs of the
//                          nodes in the current near queue, appending each
//                          node it lowers to the next near queue (its new
//                          distance in the current bucket) or to the far
//                          pile (beyond it);
//   sssp_frontier_advance  the next bucket: filter the far pile, moving
//                          the entries of the least pending bucket into
//                          the near queue, dropping stale ones, keeping
//                          the rest.
// A run is reset once, then the device loop's nested WHILE nodes run
// relax until the near queue is empty and advance until no bucket is
// left.  Every step writes its state in place and sets the loops' flags,
// so the captured loop copies nothing: a settle step is one relax launch
// and the loop's condition kernel, and touches no n-sized array.
//
// Replaces no pl.pallas_call: graph_tpu's frontier engine
// (_sssp_frontier_device, graph_tpu/algos/sssp.py:137-192) is XLA ops
// over the whole graph each step: the bucket of every node, a
// nonzero(size=cap) over n, a gather of cap padded adjacency rows and a
// scatter-min over n.  In PyTorch the same chain ran as about a dozen
// n-sized kernels a step (graph_tpu_torch/algos/sssp.py, _settle), and
// its padded (n+1, max degree) adjacency does not fit a Kronecker graph.
//
// State (all in device memory):
//   dist    (n,) f32.  Nonnegative floats order as their int32 bits, so an
//           atomicMin on the bits is the relaxation; f32::MAX is unreached.
//   stamp   (n,) int32: the step whose near queue holds the node, so a node
//           enters a queue at most once; far_in (n,) int32: 1 while the
//           node is in the far pile, so it enters the pile at most once.
//   two near queues, each three (n,) arrays: the node, its first arc and
//           its first arc's place among the queue's arcs (an exclusive scan
//           of the entries' out-degrees), and `tile`: for each tile of
//           kTile arcs, the entry its first arc belongs to;
//   two far piles, (n,) node ids each, with their counts and the least
//           bucket appended to each;
//   Ctrl    the queues' heads, (entries << 32) | arcs in one 64-bit word so
//           that one atomicAdd reserves both, the step, the bucket, the
//           run's relaxed arcs and the last-block ticket.
//
// Exactness.  Every relaxation writes fl(dist[v] + w), a path length, and
// a node lowered at any time is relaxed again later, at a step that reads
// its lowered distance or a lower one.  fl(d + w) is monotone in d, so
// every order of relaxations ends at the same f32 fixed point as
// Bellman-Ford: the distances are those of the plan engine bit for bit.
// Only the schedule (which step lowers which node first, and so the count
// of steps and relaxed arcs) depends on the order in which the card's
// threads meet.
//
// Design.
//   - Arcs, not nodes, are spread over the grid: a block takes tiles of
//     kTile consecutive arcs of the queue (its arcs in queue order), finds
//     the entry of the tile's first arc in `tile`, stages the kTile
//     entries from there in shared memory and finds each thread's entry by
//     a binary search in them.  A node of 10^5 arcs is 400 tiles, spread
//     over the grid like any other.  Thread t takes arc t of the tile, so a
//     warp's loads of targets and weights fall on consecutive arcs.
//   - A thread reads the target's distance first and takes the atomic
//     only where it would lower it.
//   - Appends are gathered in shared memory (2,048 near entries with their
//     out-degrees, 2,048 far ids) and flushed with one atomicAdd on the
//     queue's head a flush: a block scans its entries' out-degrees and
//     reserves entries and arcs at once, so the queue's arc offsets stay a
//     scan in entry order.  A dense step of millions of appends takes
//     thousands of atomics on the head, not millions.  A node without
//     out-arcs is never appended: relaxing it would read nothing.
//   - The grid is persistent (four blocks of 256 threads on each SM); the
//     last block to finish, found by a ticket that also adds up the near
//     entries appended, swaps the queues, counts the step's arcs and sets
//     the flags the loop's condition kernel reads.  A block's first tile's
//     entry is loaded for both queues beside the run's scalars, and its far
//     ids are reserved beside its near entries, to save dependent trips.
//   - The next bucket needs no pass of its own: each pile carries the
//     least bucket of every far-range lowering and of every kept entry, a
//     lower bound of its pending entries' buckets.  A node lowered into the
//     current bucket after its far append leaves that bound too low at
//     worst, which makes one bucket empty: the settle loop then runs no
//     step and the next advance finds the next.
//
// Bound: a step is latency-bound where its queue is short (about nine
// dependent trips to the L2: the run's scalars with the tile's entry, the
// entries, the arc, the target's distance, the atomic with the target's
// offsets, the stamp, the head's reservation, the fence, the ticket; an
// empty step costs 2.7-3.4 us in a CUDA graph), bytes where it is dense:
// 8 B an arc of the queue (target, weight) read once, with the random
// reads of distances served by the L2 (16.8 MB at n = 2^22).

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;           // arcs a tile, one a thread
constexpr int kNearCap = 2048;            // near entries a block gathers
constexpr int kFarCap = 2048;             // far ids a block gathers
constexpr int kPer = kNearCap / kThreads; // near entries a thread flushes
constexpr int kBlocksPerSm = 4;
constexpr long long kNoBin = INT_MAX;     // no bucket (kernels.IMAX)
// Bucket numbers clamp here before the int cast (kernels.BIN_CLAMP).
constexpr float kBinClamp = 2147483520.0f;  // f32(2^31 - 128)

// The run's scalars, 16 int64 words (sssp_frontier's `ctrl`; the plain
// versions in engine/kernels.py index the same words).
struct Ctrl {
  unsigned long long head[2];  // near queue q: (entries << 32) | arcs
  long long relaxed;           // arcs the run's steps relaxed
  long long cur;               // the near queue the next step reads
  long long step;              // that step's number (stamps)
  long long bucket;            // the bucket being settled
  long long fc;                // the far pile steps append to
  unsigned long long far_count[2];
  long long far_min[2];        // least bucket appended to each pile
  unsigned long long ticket;   // blocks finished, near entries appended
  long long spare[4];
};
static_assert(sizeof(Ctrl) == 16 * 8, "Ctrl is 16 int64 words");

struct Work {
  const long long* offsets;  // (n + 1,) out-CSR offsets
  const int* targets;        // (m,) out-CSR targets
  const float* weights;      // (m,) f32
  float* dist;               // (n,)
  int* stamp;                // (n,)
  int* far_in;               // (n,)
  int* qnode[2];             // (n,) each
  unsigned* qbeg[2];         // (n,) each: the entry's first arc
  unsigned* qoff[2];         // (n,) each: its place among the queue's arcs
  int* qtile[2];             // (tiles,) each
  int* far[2];               // (n,) each
  Ctrl* ctrl;
  long long n;
  long long n_tiles;  // each qtile's length
  float delta;
};

__device__ __forceinline__ long long bucket_of(float d, float delta) {
  if (!(d < FLT_MAX)) return kNoBin;
  return (long long)(int)fminf(__fdiv_rn(d, delta), kBinClamp);
}

// Appends a block gathers in shared memory before it flushes them.
struct Gather {
  int near_node[kNearCap];
  unsigned near_deg[kNearCap];
  unsigned near_beg[kNearCap];
  int far_node[kFarCap];
  int n_near, n_far;
  unsigned appended;  // near entries this block appended
  long long min_bin;
  unsigned long long base, far_base;
  unsigned warp_sum[kThreads / 32];
};

__device__ __forceinline__ void gather_init(Gather& g) {
  if (threadIdx.x == 0) {
    g.n_near = 0;
    g.n_far = 0;
    g.appended = 0;
    g.min_bin = kNoBin;
  }
  __syncthreads();
}

__device__ __forceinline__ void push_near(Gather& g, int node, unsigned deg,
                                          unsigned beg) {
  const int p = atomicAdd(&g.n_near, 1);
  g.near_node[p] = node;
  g.near_deg[p] = deg;
  g.near_beg[p] = beg;
}

__device__ __forceinline__ void push_far(Gather& g, int node) {
  g.far_node[atomicAdd(&g.n_far, 1)] = node;
}

// Exclusive scan of v over the block; *total gets the sum.  Every thread
// calls it.
__device__ __forceinline__ unsigned block_scan(Gather& g, unsigned v,
                                               unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) g.warp_sum[warp] = incl;
  __syncthreads();
  unsigned before = 0, all = 0;
  for (int k = 0; k < kThreads / 32; ++k) {
    const unsigned s = g.warp_sum[k];
    if (k < warp) before += s;
    all += s;
  }
  __syncthreads();  // warp_sum is free again
  *total = all;
  return before + incl - v;
}

// Move the gathered near entries to near queue q and the gathered far
// ids to far pile f.  One atomicAdd on the queue's head reserves the near
// entries and their arcs, whose offsets are the block's scan of their
// out-degrees, and each tile whose first arc falls in an entry's arcs
// points at that entry; another, beside it, reserves the far ids.  Every
// thread calls it.
__device__ void flush(Gather& g, const Work& w, int q, int f) {
  __syncthreads();
  const int count = g.n_near, far_count = g.n_far;
  const int lo = threadIdx.x * kPer;
  const int hi = min(lo + kPer, count);
  unsigned mine = 0;
  for (int j = lo; j < hi; ++j) mine += g.near_deg[j];
  unsigned total;
  unsigned off = block_scan(g, mine, &total);
  if (threadIdx.x == 0 && count) {
    g.base = atomicAdd(&w.ctrl->head[q],
                       ((unsigned long long)count << 32) | total);
    g.appended += count;
  }
  if (threadIdx.x == 32 && far_count) {
    g.far_base = atomicAdd(&w.ctrl->far_count[f],
                           (unsigned long long)far_count);
  }
  __syncthreads();
  const unsigned long long base = g.base;
  const unsigned idx0 = (unsigned)(base >> 32);
  off += (unsigned)base;
  int* const qnode = w.qnode[q];
  unsigned* const qbeg = w.qbeg[q];
  unsigned* const qoff = w.qoff[q];
  int* const qtile = w.qtile[q];
  for (int j = lo; j < hi; ++j) {
    const unsigned idx = idx0 + (unsigned)j;
    const unsigned deg = g.near_deg[j];
    qnode[idx] = g.near_node[j];
    qbeg[idx] = g.near_beg[j];
    qoff[idx] = off;
    // the tiles whose first arc lies in [off, off + deg)
    const unsigned long long end = (unsigned long long)off + deg;
    for (unsigned long long t = ((unsigned long long)off + kTile - 1) / kTile;
         t * kTile < end; ++t) {
      qtile[t] = (int)idx;
    }
    off += deg;
  }
  int* const far = w.far[f] + g.far_base;
  for (int j = threadIdx.x; j < far_count; j += kThreads) {
    far[j] = g.far_node[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) g.n_near = g.n_far = 0;
  __syncthreads();
}

// The block's least bucket into far pile f's bound.  Every thread calls
// it, with its own least bucket.
__device__ void flush_min(Gather& g, const Work& w, int f, long long mine) {
  if (mine != kNoBin) atomicMin(&g.min_bin, mine);
  __syncthreads();
  if (threadIdx.x == 0 && g.min_bin != kNoBin) {
    atomicMin(&w.ctrl->far_min[f], g.min_bin);
  }
}

// Whether this block is the last of the grid to finish (every block's
// writes before it are then visible to it); in the last block's thread 0,
// *appended gets the near entries the grid appended.  The ticket counts
// blocks in its low kTicketBits bits and near entries above them, so the
// last block needs no read of the queue's head.
constexpr int kTicketBits = 20;
__device__ bool last_block(Gather& g, const Work& w,
                           unsigned long long* appended) {
  __shared__ bool last;
  __threadfence();  // this thread's writes are seen before the ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long mine =
        1ull | ((unsigned long long)g.appended << kTicketBits);
    const unsigned long long before = atomicAdd(&w.ctrl->ticket, mine);
    last = (before & ((1ull << kTicketBits) - 1)) == gridDim.x - 1;
    *appended = (before + mine) >> kTicketBits;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__global__ void __launch_bounds__(kThreads)
    sssp_reset_kernel(Work w, long long source, int* settle, int* more) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i = first; i < w.n; i += stride) {
    w.dist[i] = i == source ? 0.0f : FLT_MAX;
    w.stamp[i] = -1;
    w.far_in[i] = 0;
  }
  const long long beg = w.offsets[source];
  const long long deg = w.offsets[source + 1] - beg;
  for (long long t = first; t * kTile < deg; t += stride) w.qtile[0][t] = 0;
  if (first == 0) {
    Ctrl* c = w.ctrl;
    c->head[0] = deg ? (1ull << 32) | (unsigned long long)deg : 0ull;
    c->head[1] = 0;
    w.qnode[0][0] = (int)source;
    w.qbeg[0][0] = (unsigned)beg;
    w.qoff[0][0] = 0;
    c->relaxed = 0;
    c->cur = 0;
    c->step = 0;
    c->bucket = 0;
    c->fc = 0;
    c->far_count[0] = c->far_count[1] = 0;
    c->far_min[0] = c->far_min[1] = kNoBin;
    c->ticket = 0;
    *settle = 1;
    *more = 1;
  }
}

__global__ void __launch_bounds__(kThreads)
    sssp_relax_kernel(Work w, int* settle) {
  __shared__ Gather g;
  __shared__ unsigned s_off[kTile];
  __shared__ int s_node[kTile];
  __shared__ unsigned s_beg[kTile];
  Ctrl* const c = w.ctrl;
  // the first tile's entry of both queues, loaded beside the scalars
  const bool tiled = blockIdx.x < w.n_tiles;
  const int first0 = tiled ? w.qtile[0][blockIdx.x] : 0;
  const int first1 = tiled ? w.qtile[1][blockIdx.x] : 0;
  const int cur = (int)c->cur, nxt = cur ^ 1;
  const unsigned long long h0 = c->head[0], h1 = c->head[1];
  const unsigned long long head = cur ? h1 : h0;  // loaded beside cur
  const unsigned count = (unsigned)(head >> 32);
  const unsigned arcs = (unsigned)head;
  const int step = (int)c->step;
  const int next_stamp = step + 1;
  const long long b = c->bucket;
  const int fc = (int)c->fc;
  gather_init(g);
  long long min_bin = kNoBin;
  const unsigned tiles = (arcs + kTile - 1) / kTile;
  for (unsigned tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const unsigned e0 = tile * kTile;
    const unsigned i0 = (unsigned)(tile == blockIdx.x ? (cur ? first1 : first0)
                                                     : w.qtile[cur][tile]);
    const unsigned i = i0 + threadIdx.x;
    if (i < count) {
      s_off[threadIdx.x] = w.qoff[cur][i];
      s_node[threadIdx.x] = w.qnode[cur][i];
      s_beg[threadIdx.x] = w.qbeg[cur][i];
    } else {
      s_off[threadIdx.x] = UINT_MAX;  // past every arc
    }
    __syncthreads();
    const unsigned e = e0 + threadIdx.x;
    if (e < arcs) {
      int lo = 0, hi = kTile;  // s_off[lo] <= e < s_off[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_off[mid] <= e) lo = mid; else hi = mid;
      }
      const unsigned a = s_beg[lo] + (e - s_off[lo]);
      const int t = w.targets[a];
      const float nd = __fadd_rn(__ldcg(w.dist + s_node[lo]), w.weights[a]);
      if (nd < __ldcg(w.dist + t)) {
        const int bits = __float_as_int(nd);
        // the target's arcs are loaded beside the atomic, not after it
        const long long o0 = w.offsets[t];
        const long long o1 = w.offsets[t + 1];
        if (bits < atomicMin(reinterpret_cast<int*>(w.dist) + t, bits)) {
          const unsigned deg = (unsigned)(o1 - o0);
          if (deg) {
            const long long tb = bucket_of(nd, w.delta);
            if (tb <= b) {
              if (atomicExch(w.stamp + t, next_stamp) != next_stamp) {
                push_near(g, t, deg, (unsigned)o0);
              }
            } else {
              min_bin = min(min_bin, tb);
              if (atomicExch(w.far_in + t, 1) == 0) push_far(g, t);
            }
          }
        }
      }
    }
    __syncthreads();
    if (g.n_near > kNearCap - kTile || g.n_far > kFarCap - kTile) {
      flush(g, w, nxt, fc);
    }
  }
  if (g.n_near || g.n_far) flush(g, w, nxt, fc);
  flush_min(g, w, fc, min_bin);
  unsigned long long appended = 0;
  if (last_block(g, w, &appended) && threadIdx.x == 0) {
    c->head[cur] = 0;
    c->cur = nxt;
    c->step = next_stamp;
    c->relaxed += arcs;
    c->ticket = 0;
    *settle = appended != 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    sssp_advance_kernel(Work w, int* settle, int* more) {
  __shared__ Gather g;
  Ctrl* const c = w.ctrl;
  const int fc = (int)c->fc, nf = fc ^ 1;
  const int cur = (int)c->cur;
  const long long next_bin = c->far_min[fc];
  const long long count = (long long)c->far_count[fc];
  gather_init(g);
  long long min_bin = kNoBin;
  for (long long base = (long long)blockIdx.x * kThreads; base < count;
       base += (long long)gridDim.x * kThreads) {
    const long long i = base + threadIdx.x;
    if (i < count) {
      const int v = w.far[fc][i];
      const long long bb = bucket_of(__ldcg(w.dist + v), w.delta);
      if (bb > next_bin) {  // pending beyond the next bucket: kept
        min_bin = min(min_bin, bb);
        push_far(g, v);
      } else {  // the next bucket's, or stale (settled in an earlier one)
        w.far_in[v] = 0;
        if (bb == next_bin) {
          const long long o0 = w.offsets[v];
          push_near(g, v, (unsigned)(w.offsets[v + 1] - o0), (unsigned)o0);
        }
      }
    }
    __syncthreads();
    if (g.n_near > kNearCap - kThreads || g.n_far > kFarCap - kThreads) {
      flush(g, w, cur, nf);
    }
  }
  if (g.n_near || g.n_far) flush(g, w, cur, nf);
  flush_min(g, w, nf, min_bin);
  unsigned long long appended = 0;
  if (last_block(g, w, &appended) && threadIdx.x == 0) {
    c->far_count[fc] = 0;
    c->far_min[fc] = kNoBin;
    c->fc = nf;
    if (next_bin != kNoBin) c->bucket = next_bin;
    c->ticket = 0;
    *settle = appended != 0;
    *more = next_bin != kNoBin;
  }
}

// The state's arrays from the caller's tensors: marks (2, n) int32 (stamp,
// far_in), queues (8, n) int32 (qnode, qbeg, qoff of each near queue, then
// the two far piles), tiles (2, tiles) int32.
Work make_work(const void* offsets, const void* targets, const void* weights,
               void* dist, void* marks, void* queues, void* tiles, void* ctrl,
               long long n, long long n_tiles, float delta) {
  Work w;
  w.offsets = static_cast<const long long*>(offsets);
  w.targets = static_cast<const int*>(targets);
  w.weights = static_cast<const float*>(weights);
  w.dist = static_cast<float*>(dist);
  int* m = static_cast<int*>(marks);
  w.stamp = m;
  w.far_in = m + n;
  int* q = static_cast<int*>(queues);
  for (int k = 0; k < 2; ++k) {
    w.qnode[k] = q + k * n;
    w.qbeg[k] = reinterpret_cast<unsigned*>(q + (2 + k) * n);
    w.qoff[k] = reinterpret_cast<unsigned*>(q + (4 + k) * n);
    w.far[k] = q + (6 + k) * n;
    w.qtile[k] = static_cast<int*>(tiles) + k * n_tiles;
  }
  w.ctrl = static_cast<Ctrl*>(ctrl);
  w.n = n;
  w.n_tiles = n_tiles;
  w.delta = delta;
  return w;
}

int grid_blocks() {
  static int blocks = 0;
  if (!blocks) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      return 0;
    }
    blocks = kBlocksPerSm * sms;
  }
  return blocks;
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers: offsets (n + 1,) int64 from 0, targets
// (m,) int32 below n, weights (m,) f32 >= 0 with m < 2^32; the state as
// make_work reads it; ctrl 16 int64; settle and more one int32 each (the
// device loop's flags).  `source` is read by reset alone, `delta` (the
// bucket width, f32 > 0) by relax and advance.
#define SSSP_FRONTIER_ARGS                                                    \
  const void *offsets, const void *targets, const void *weights, void *dist, \
      void *marks, void *queues, void *tiles, void *ctrl, void *settle,      \
      void *more, long long n, long long n_tiles, long long source,          \
      float delta, void *stream
#define SSSP_FRONTIER_WORK                                                 \
  make_work(offsets, targets, weights, dist, marks, queues, tiles, ctrl, n, \
            n_tiles, delta)

extern "C" int sssp_frontier_reset(SSSP_FRONTIER_ARGS) {
  const int blocks = grid_blocks();
  if (!blocks) return (int)cudaGetLastError();
  sssp_reset_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      SSSP_FRONTIER_WORK, source, static_cast<int*>(settle),
      static_cast<int*>(more));
  return (int)cudaGetLastError();
}

extern "C" int sssp_frontier_relax(SSSP_FRONTIER_ARGS) {
  const int blocks = grid_blocks();
  if (!blocks) return (int)cudaGetLastError();
  sssp_relax_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      SSSP_FRONTIER_WORK, static_cast<int*>(settle));
  return (int)cudaGetLastError();
}

extern "C" int sssp_frontier_advance(SSSP_FRONTIER_ARGS) {
  const int blocks = grid_blocks();
  if (!blocks) return (int)cudaGetLastError();
  sssp_advance_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      SSSP_FRONTIER_WORK, static_cast<int*>(settle), static_cast<int*>(more));
  return (int)cudaGetLastError();
}
