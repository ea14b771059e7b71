// K2: per-destination reduction of slot contributions, for d < n, over the
// row contrib[indptr[d] : indptr[d+1]]:
//   k2_reduce:      y[d] = sum mod 2^32 (int32 fixed-point quanta); empty
//                   rows give 0;
//   k2_reduce_min:  y[d] = min(fill, min of the row) as signed int32; empty
//                   rows give fill.
//
// Replaces graph_tpu/engine/kernels.py:603 (k2_reduce, its _k2_kernel in
// both the legacy and the scan-depth-classed form), op="sum", "min" and
// "imin".  The TPU kernel routes each 65,536-slot section through a Benes
// network into destination order and runs a segmented scan in VMEM; here
// the plan already stores slots in destination order with row offsets, so
// the reduction reads each row's run directly.  Routes and scan classes
// have no role on Hopper.
//
// One min kernel serves both min ops; the wrapper passes the fill:
//   op="imin" (int32 labels):      fill 2^31-1 (kernels.py:382);
//   op="min"  (f32 bit patterns):  fill 2137108966, the bits of 3e38
//                                  (kernels.py:381).
// For nonnegative f32 values, signed int32 order of the bit patterns is
// IEEE order, so an integer min computes the f32 min; the TPU kernel's
// accumulator starts at the fill, so a row's min is never above the fill
// there either.
//
// Bound: bytes.  A call reads contrib (4 B/slot) and indptr (8 B/node) and
// writes y (4 B/node): 4*m + 12*n, 319 MB at RMAT scale 22 (0.095 ms at the
// data-sheet 3.35 TB/s) and 587 MB at the symmetrized WCC shapes (m = 2^27,
// 0.175 ms); m integer additions or compares are far below any compute
// limit.
//
// Design: a merge-path segmented reduction (Merrill and Garland, "Merge-
// based Parallel Sparse Matrix-Vector Multiplication", SC '16).  Power-law
// rows are the problem: at scale 22 half the rows are empty and the largest
// holds 160,441 slots (320,807 symmetrized).  A warp per row pays a chain of
// dependent loads (indptr, then contrib, then a shuffle tree) for every row,
// however short, and walks a hub row alone.  Here the n row ends and the m
// slots form one merged sequence of n + m items (a row's slots, then its
// end), cut into tiles of equal size (kTile items; tile t starts at
// diagonal floor(t * (n + m) / ntiles)), so an empty row, a short row and
// a hub row cost the same per item.
//   - Where each tile starts (its row; its slot follows from the diagonal)
//     is computed once per plan, outside the kernel
//     (graph_tpu_torch/engine/kernels.py:k2_tile_cuts).
//   - A block of 128 threads takes one tile of 1,920 items (7.5 KB of
//     contrib); small blocks keep ten tiles in flight on each SM, so one
//     tile's loads overlap the others' arithmetic (chosen on the card at
//     RMAT scale 22 over 64-256 threads and 11-31 items per thread).
//   - A block stages its tile's contrib slice and row ends in shared memory
//     with 16-byte loads (a scalar head and tail cover slices that do not
//     start or end on 16 bytes, so any tensor view works), streamed past
//     the L2 (evict-first).
//   - Each thread finds its own start in the tile by a binary search in
//     shared memory, then reduces kItems merged items serially: a slot adds
//     into the running value, a row end emits it.
//   - A block-wide segmented scan (shuffles within a warp, shared memory
//     across warps) carries each thread's trailing partial into the first
//     row that the next threads end; every row that ends in the tile is
//     stored once, directly, by the thread that holds its end.
//   - A row that crosses tiles leaves one carry per tile (the tile's
//     trailing partial, keyed by the row the next tile starts in).  A second
//     small pass, after the first in stream order, folds each carry into y
//     with one atomic: atomicAdd on unsigned int (wraps mod 2^32) or
//     atomicMin on int.  Integer addition and min are associative and
//     commutative, so the order in which atomics land cannot change a bit:
//     the result equals the plain version's on every run.  (For f32 sums
//     it would not; the engine sums in int32 fixed point for that reason.)
//   The sum is kept in uint32_t: unsigned addition wraps mod 2^32, which is
//   the engine's fixed-point contract, while signed overflow is undefined in
//   C++.  The result is stored as int32 (two's complement).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
// Odd, so that threads reading their runs of slots from shared memory fall
// on different banks.
constexpr int kItems = 15;
constexpr int kTile = kThreads * kItems;  // 1920 merged items per tile
constexpr unsigned kFull = 0xffffffffu;

struct SumOp {
  using T = uint32_t;
  __device__ T identity() const { return 0u; }
  __device__ T operator()(T a, T b) const { return a + b; }
  __device__ void atomic(int32_t* p, T v) const {
    atomicAdd(reinterpret_cast<unsigned int*>(p), v);
  }
};

struct MinOp {
  using T = int32_t;
  int32_t fill;
  __device__ T identity() const { return fill; }
  __device__ T operator()(T a, T b) const { return min(a, b); }
  __device__ void atomic(int32_t* p, T v) const { atomicMin(p, v); }
};

// s[k + pad] = g[lo + k] for k < cnt, where pad (returned, 0..3) puts the
// first 16-byte-aligned element of g on a 16-byte boundary of s.
__device__ __forceinline__ int stage_slots(const int32_t* __restrict__ g,
                                           long long lo, int cnt,
                                           int32_t* s) {
  const int pad =
      (int)((reinterpret_cast<uintptr_t>(g + lo) >> 2) & 3);  // past 16 B
  const int head = min((4 - pad) & 3, cnt);
  for (int k = threadIdx.x; k < head; k += kThreads) {
    s[k + pad] = __ldcs(g + lo + k);
  }
  const int nvec = (cnt - head) >> 2;
  const int4* gv = reinterpret_cast<const int4*>(g + lo + head);
  int4* sv = reinterpret_cast<int4*>(s + head + pad);
  for (int v = threadIdx.x; v < nvec; v += kThreads) sv[v] = __ldcs(gv + v);
  for (int k = head + 4 * nvec + threadIdx.x; k < cnt; k += kThreads) {
    s[k + pad] = __ldcs(g + lo + k);
  }
  return pad;
}

// s[k] = g[lo + k] - base for k < cnt (row ends, relative to the tile's
// first slot), 16-byte loads between a scalar head and tail.
__device__ __forceinline__ void stage_ends(const long long* __restrict__ g,
                                           long long lo, int cnt,
                                           long long base, int32_t* s) {
  const int head =
      min((int)((reinterpret_cast<uintptr_t>(g + lo) >> 3) & 1), cnt);
  if (head && threadIdx.x == 0) s[0] = (int32_t)(__ldcs(g + lo) - base);
  const int npair = (cnt - head) >> 1;
  const longlong2* gv = reinterpret_cast<const longlong2*>(g + lo + head);
  for (int v = threadIdx.x; v < npair; v += kThreads) {
    const longlong2 e = __ldcs(gv + v);
    s[head + 2 * v] = (int32_t)(e.x - base);
    s[head + 2 * v + 1] = (int32_t)(e.y - base);
  }
  const int k = head + 2 * npair;
  if (k < cnt && threadIdx.x == 0) s[k] = (int32_t)(__ldcs(g + lo + k) - base);
}

template <typename Op>
__global__ void __launch_bounds__(kThreads)
    k2_tile_kernel(const int32_t* __restrict__ contrib,
                   const long long* __restrict__ indptr,
                   const long long* __restrict__ cuts,
                   typename Op::T* __restrict__ carries,
                   int32_t* __restrict__ y, long long total, long long ntiles,
                   Op op) {
  using T = typename Op::T;
  __shared__ __align__(16) int32_t s_val[kTile + 4];
  __shared__ int32_t s_end[kTile];
  __shared__ T s_warp[kThreads / 32];
  __shared__ int s_wflag[kThreads / 32];

  // The tile: merged items [d0, d1), rows [row0, row1) end in it, slots
  // [slot0, slot1) lie in it; row1 continues past it (or row1 == n).
  const long long t = blockIdx.x;
  const long long d0 = t * total / ntiles;
  const long long d1 = (t + 1) * total / ntiles;
  const long long row0 = cuts[t];
  const long long row1 = cuts[t + 1];
  const long long slot0 = d0 - row0;
  const int nrows = (int)(row1 - row0);
  const int nslots = (int)((d1 - row1) - slot0);
  const int items = (int)(d1 - d0);

  const int pad = stage_slots(contrib, slot0, nslots, s_val);
  stage_ends(indptr, row0 + 1, nrows, slot0, s_end);
  __syncthreads();

  // This thread's items [dt, dn) of the tile.  Its start (i rows ended, j
  // slots taken) is where the merge path crosses diagonal dt: i = the
  // number of row ends k with position s_end[k] + k < dt.
  const int tid = threadIdx.x;
  const int dt = min(tid * kItems, items);
  const int dn = min(dt + kItems, items);
  int lo = max(0, dt - nslots);
  int hi = min(dt, nrows);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_end[mid] + mid < dt) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo;
  int j = dt - lo;
  int end = i < nrows ? s_end[i] : INT_MAX;

  // Serial reduction.  The first row this thread ends may have begun in
  // earlier threads: hold its partial until the block scan; store the rest.
  T acc = op.identity();
  T first = op.identity();
  int first_row = -1;
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    if (dt + s < dn) {
      if (j < end) {
        acc = op(acc, (T)s_val[j + pad]);
        ++j;
      } else {
        if (first_row < 0) {
          first = acc;
          first_row = i;
        } else {
          y[row0 + i] = (int32_t)acc;
        }
        acc = op.identity();
        ++i;
        end = i < nrows ? s_end[i] : INT_MAX;
      }
    }
  }

  // Block-wide segmented inclusive scan of (ended a row, trailing partial):
  // (f1, v1) then (f2, v2) = (f1 | f2, f2 ? v2 : v1 op v2).
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int f = first_row >= 0;
  T v = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T vo = __shfl_up_sync(kFull, v, off);
    const int fo = __shfl_up_sync(kFull, f, off);
    if (lane >= off) {
      if (!f) v = op(vo, v);
      f |= fo;
    }
  }
  if (lane == 31) {
    s_warp[warp] = v;
    s_wflag[warp] = f;
  }
  __syncthreads();
  T before = op.identity();  // the warps before this one, scanned
  for (int w = 0; w < warp; ++w) {
    before = s_wflag[w] ? s_warp[w] : op(before, s_warp[w]);
  }
  const T incl = f ? v : op(before, v);
  T carry_in = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) carry_in = before;
  if (first_row >= 0) y[row0 + first_row] = (int32_t)op(carry_in, first);
  if (tid == kThreads - 1) carries[t] = incl;  // row1's part in this tile
}

// After the tile pass: fold each tile's carry into the row it belongs to.
template <typename Op>
__global__ void k2_carry_kernel(const typename Op::T* __restrict__ carries,
                                const long long* __restrict__ cuts,
                                int32_t* __restrict__ y, long long n,
                                long long ntiles, Op op) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < ntiles; t += stride) {
    const long long row = cuts[t + 1];
    const typename Op::T v = carries[t];
    if (row < n && v != op.identity()) op.atomic(y + row, v);
  }
}

template <typename Op>
int launch(const void* contrib, const void* indptr, const void* cuts,
           void* carries, void* y, long long n, long long m, long long ntiles,
           Op op, void* stream) {
  if (n <= 0) return 0;
  const long long total = n + m;
  // every tile must fit the kernel's shared-memory buffers
  if (ntiles < 1 || ntiles > INT_MAX || ntiles < (total + kTile - 1) / kTile) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  auto* c = static_cast<typename Op::T*>(carries);
  const auto* cu = static_cast<const long long*>(cuts);
  k2_tile_kernel<Op><<<(unsigned)ntiles, kThreads, 0, s>>>(
      static_cast<const int32_t*>(contrib),
      static_cast<const long long*>(indptr), cu, c, static_cast<int32_t*>(y),
      total, ntiles, op);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long want = (ntiles + 255) / 256;
  k2_carry_kernel<Op><<<(unsigned)(want < 1024 ? want : 1024), 256, 0, s>>>(
      c, cu, static_cast<int32_t*>(y), n, ntiles, op);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() after each of the two
// launches (0 on success).  indptr holds n + 1 nondecreasing offsets from 0
// to m; cuts (ntiles + 1, int64) holds each tile's first row; carries
// (ntiles, int32) is scratch.  Returns cudaErrorInvalidValue, launching
// nothing, when a tile would hold more than kTile items.
extern "C" int k2_reduce(const void* contrib, const void* indptr,
                         const void* cuts, void* carries, void* y,
                         long long n, long long m, long long ntiles,
                         void* stream) {
  return launch(contrib, indptr, cuts, carries, y, n, m, ntiles, SumOp{},
                stream);
}

// The same contract, with the row min (capped at fill) instead of the sum.
extern "C" int k2_reduce_min(const void* contrib, const void* indptr,
                             const void* cuts, void* carries, void* y,
                             long long n, long long m, long long ntiles,
                             int fill, void* stream) {
  return launch(contrib, indptr, cuts, carries, y, n, m, ntiles,
                MinOp{static_cast<int32_t>(fill)}, stream);
}
