// Triangle count's join: the number of triangles of a graph oriented by
// rank, as
//   count = sum over heads u in [h0, h1) and over i < j < d+(u) of
//           [N+(u)[j] in N+(N+(u)[i])],
// where N+(u) are the targets of u's forward edges, sorted, every one
// above u.  Since every w in N+(v) lies above v = N+(u)[i], and N+(u) is
// sorted, this is the sum over forward edges (u, v) of |N+(u) ∩ N+(v)|:
// each triangle u < v < w once.
//
// Replaces no pl.pallas_call: graph_tpu's join (_join_count,
// graph_tpu/algos/triangle_count.py:100) is an XLA sort of every slab of
// emitted wedges together with all edge keys.  In PyTorch it ran as the
// emission of each wedge (v, w) into memory, an int64 key v << 30 | w, a
// torch.searchsorted of the key among all sorted edge keys and a gather
// (graph_tpu_torch/algos/triangle_count.py, _run_join): some 9.5e9 wedge
// slots a count on GAP kron at scale 22, 2 s of device time in about 290
// steps, most of it the searches' dependent reads of a 512 MB key array.
//
// Bound: bytes.  The forward CSR read once (8 B an offset, 4 B a target,
// 288 MB at kron scale 22) takes 0.09 ms at the data-sheet 3.35 TB/s; no
// design reads only that.  This one reads each N+(v) once for every
// forward edge (u, v) whose v can close a wedge: sum over those edges of
// d+(v) targets, 2.9e10 at kron scale 22 (4 W for W = 7.2e9 wedges), plus
// 20 B an edge for v and its offsets and N+(u) once: 114 GB, 34 ms at
// 3.35 TB/s, though much of it is served by the L2, since the hubs' lists
// are short and read again and again (chip_smoke.py's tc_count_reads
// counts it).
// What bounds it on the card is the lookups: with the loads alone (every
// target read, none looked up) the kernel took 30 ms at kron scale 22, and
// the first design, a hash table four times the tile with Fibonacci
// hashing, 67 ms, its random shared-memory probes conflicting in banks and
// diverging on collisions.
//
// Design.  No wedge is written anywhere and no key is searched for: each
// head's forward list is staged on chip and intersected with its
// neighbours' lists.
//   - A head with more than 64 forward edges (98% of the wedges at kron
//     scale 22, whose longest list holds 1,032) is one block's work: 256
//     threads stage up to 1,024 of its targets (a tile) in shared memory,
//     as a filter of 32,768 bits (bit w mod 32,768 of each target w) and a
//     hash table of 4,096 slots (at most a quarter full, Fibonacci hashing,
//     linear probing).  Then they read the lists N+(v) of its neighbours
//     v = N+(u)[i], i < the tile's last, as one flat sequence (256
//     neighbours at a time, their lengths scanned in shared memory): thread
//     t takes items t, t + 256, ..., so a warp's loads fall on consecutive
//     targets, and walks its neighbour index forward as the items pass each
//     list's end.  Each thread issues eight loads before it looks them up.
//     A target outside the tile's range, or whose bit is clear (nearly
//     every miss: a tile sets at most 1 bit in 32), costs one shared-memory
//     read and no probe; the sorted targets of a list fall on few words, so
//     the filter's reads rarely conflict in banks.  A longer list is
//     counted tile by tile; the tiles partition N+(u), so the counts add up.
//   - A head with 2 to 64 forward edges is one warp's work, by the same
//     code with a filter of 2,048 bits and a table of 256 slots; a warp
//     takes 4 such heads at a time.  Heads with fewer than two forward
//     edges close no wedge and are not scheduled.
//   - The grid is persistent (eight blocks of 25 KB of shared memory on
//     each SM, 32 registers a thread): blocks take the long heads one at a
//     time from a counter, then each warp takes short heads.  The largest
//     head is well under a millisecond of one block, so no order by work is
//     needed.
//   - Counts stay in registers; a block adds its total into one int64 with
//     one atomicAdd, so the count is exact and the same on every run.
//   - Nothing is allocated: the caller zeroes three int64 (the total and
//     the two counters).  The head range [h0, h1) picks the scheduled heads
//     in it by a binary search in each block, so shards of one graph each
//     count a contiguous range of heads, and the counts add up.
//
// Chosen on the card at kron scale 22 (H100 80GB HBM3, 700 W): the filter
// took the kernel from 54 to 44 ms; tiles of 2,048, tables an eighth full,
// blocks of 128 or 512 threads, 4 or 16 loads in flight, 5 to 7 blocks an
// SM and a head class bound of 32 or 128 were each as fast or slower.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;  // threads a block
constexpr int kWarps = kBlock / 32;
constexpr int kBlocksPerSm = 8;  // as many as the shared memory allows
constexpr int kUnroll = 8;  // loads a thread issues before it probes
constexpr int kEmpty = -1;  // an empty hash slot (ids are nonnegative)
constexpr int kShortBatch = 4;  // short heads a warp takes at once
constexpr unsigned kFull = 0xffffffffu;

// A group of threads that counts one head: a block or a warp.  kTile
// targets at most a stage, kHash slots (four a target or more), kChunk
// neighbours at a time, a filter of kBits bits.
template <int kThreads, int kTile, int kHash, int kChunk, int kBits>
struct Shape {
  static_assert(kHash >= 4 * kTile, "a table at most a quarter full");
  static_assert(kChunk % kThreads == 0, "whole entries a thread");
  static_assert((kBits & (kBits - 1)) == 0 && kBits >= 32, "bits: 2^k words");
  static constexpr int threads = kThreads, tile = kTile, hash = kHash,
                       chunk = kChunk, load = kHash / kTile, bits = kBits;
};
using BlockShape = Shape<kBlock, 1024, 4096, 256, 32768>;
using WarpShape = Shape<32, 64, 256, 64, 2048>;

template <typename S>
struct Stage {
  unsigned bits[S::bits / 32];  // bit w mod S::bits of each staged target
  int tab[S::hash];
  long long start[S::chunk];     // where each neighbour's list starts
  long long pre[S::chunk + 1];   // the items before each neighbour's list
};

union Smem {
  Stage<BlockShape> block;
  Stage<WarpShape> warp[kWarps];
};

__device__ __forceinline__ int rank_in(int threads) {
  return threads == 32 ? (threadIdx.x & 31) : threadIdx.x;
}

__device__ __forceinline__ void group_sync(int threads) {
  if (threads == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

__device__ __forceinline__ unsigned slot_of(int w, int shift) {
  return (static_cast<unsigned>(w) * 0x9E3779B9u) >> shift;
}

__device__ __forceinline__ void insert(int* tab, int w, int shift,
                                       unsigned mask) {
  unsigned h = slot_of(w, shift);
  for (;;) {
    const int old = atomicCAS(tab + h, kEmpty, w);
    if (old == kEmpty || old == w) return;
    h = (h + 1) & mask;
  }
}

__device__ __forceinline__ unsigned probe(const int* tab, int w, int shift,
                                          unsigned mask) {
  unsigned h = slot_of(w, shift);
  for (;;) {
    const int t = tab[h];
    if (t == w) return 1u;
    if (t == kEmpty) return 0u;
    h = (h + 1) & mask;
  }
}

__device__ __forceinline__ long long warp_inclusive(long long x) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// The group's exclusive scan of x, and its total.
__device__ __forceinline__ long long group_exclusive(int threads, long long x,
                                                     long long* sums,
                                                     long long* total) {
  const long long inc = warp_inclusive(x);
  if (threads == 32) {
    *total = __shfl_sync(kFull, inc, 31);
    return inc - x;
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 31) sums[warp] = inc;
  __syncthreads();
  long long base = 0, tot = 0;
  for (int w = 0; w < kWarps; ++w) {
    const long long s = sums[w];
    if (w < warp) base += s;
    tot += s;
  }
  __syncthreads();  // sums is free again
  *total = tot;
  return base + inc - x;
}

// The flat sequence of the neighbours' lists staged in st, of total
// items, against the table: item k lies in list i with pre[i] <= k <
// pre[i + 1], at start[i] + k - pre[i].  Each thread takes items r, r +
// threads, ..., kUnroll loads at a time, and its i only grows.  T: int
// where total fits, for cheaper index arithmetic.
template <typename S, typename T>
__device__ __forceinline__ unsigned long long walk(
    const Stage<S>& st, int r, T total, const int* __restrict__ tg, int lo,
    int hi, int shift, unsigned mask) {
  unsigned long long cnt = 0;
  int i = 0;
  T p1 = static_cast<T>(st.pre[1]);
  const int* base = tg + st.start[0];  // pre[0] is 0
  for (T k = r; k < total; k += kUnroll * S::threads) {
    int w[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const T kk = k + q * S::threads;
      w[q] = kEmpty;
      if (kk < total) {
        while (p1 <= kk) {
          ++i;
          p1 = static_cast<T>(st.pre[i + 1]);
          base = tg + (st.start[i] - st.pre[i]);
        }
        w[q] = __ldg(base + kk);
      }
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const unsigned b = static_cast<unsigned>(w[q]) & (S::bits - 1);
      if (w[q] >= lo && w[q] <= hi && ((st.bits[b >> 5] >> (b & 31)) & 1u)) {
        cnt += probe(st.tab, w[q], shift, mask);
      }
    }
  }
  return cnt;
}

// The triangles that head u closes with the targets of its list, counted
// by the group of S::threads threads (all of them call it together), at
// most S::tile targets a stage; each thread returns its part.
template <typename S>
__device__ unsigned long long count_head(int u, const long long* __restrict__ off,
                                         const int* __restrict__ tg,
                                         Stage<S>& st, long long* sums) {
  constexpr int kPer = S::chunk / S::threads;
  const int r = rank_in(S::threads);
  const long long beg = off[u];
  const long long d = off[u + 1] - beg;
  unsigned long long cnt = 0;
  for (long long t0 = 0; t0 < d; t0 += S::tile) {
    const long long t1 = t0 + S::tile < d ? t0 + S::tile : d;
    // neighbours N+(u)[i], i < t1 - 1, may close a wedge in this tile
    const long long nv = t1 - 1;
    if (nv <= 0) continue;
    const int sz = static_cast<int>(t1 - t0);
    int log_s = 5;
    while ((1 << log_s) < S::load * sz) ++log_s;
    const unsigned mask = (1u << log_s) - 1u;
    const int shift = 32 - log_s;
    for (int j = r; j <= static_cast<int>(mask); j += S::threads) {
      st.tab[j] = kEmpty;
    }
    for (int j = r; j < S::bits / 32; j += S::threads) st.bits[j] = 0u;
    group_sync(S::threads);
    for (int j = r; j < sz; j += S::threads) {
      const int w = tg[beg + t0 + j];
      const unsigned b = static_cast<unsigned>(w) & (S::bits - 1);
      atomicOr(st.bits + (b >> 5), 1u << (b & 31));
      insert(st.tab, w, shift, mask);
    }
    group_sync(S::threads);
    const int lo = tg[beg + t0], hi = tg[beg + t1 - 1];
    for (long long c0 = 0; c0 < nv; c0 += S::chunk) {
      const int nc = static_cast<int>(nv - c0 < S::chunk ? nv - c0 : S::chunk);
      long long len[kPer];
      long long part = 0;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int i = r * kPer + q;
        long long l = 0;
        if (i < nc) {
          const int v = tg[beg + c0 + i];
          const long long a = off[v];
          l = off[v + 1] - a;
          st.start[i] = a;
        }
        len[q] = l;
        part += l;
      }
      long long total;
      long long x = group_exclusive(S::threads, part, sums, &total);
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int i = r * kPer + q;
        if (i < nc) st.pre[i] = x;
        x += len[q];
      }
      if (r == 0) st.pre[nc] = total;
      group_sync(S::threads);
      cnt += total <= 0x7fffffffLL
                 ? walk<S, int>(st, r, static_cast<int>(total), tg, lo, hi,
                                shift, mask)
                 : walk<S, long long>(st, r, total, tg, lo, hi, shift, mask);
      group_sync(S::threads);  // start, pre and the table are free again
    }
  }
  return cnt;
}

// The first of the n sorted ids of a not below key.
__device__ long long lower_bound(const int* __restrict__ a, long long n,
                                 long long key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// out: the total, then the counters of long heads and of short heads
// taken, all 0 at entry.
__global__ void __launch_bounds__(kBlock, kBlocksPerSm)
    tc_count_kernel(const long long* __restrict__ off,
                    const int* __restrict__ tg,
                    const int* __restrict__ long_heads, long long n_long,
                    const int* __restrict__ short_heads, long long n_short,
                    long long h0, long long h1,
                    unsigned long long* __restrict__ out) {
  __shared__ Smem sm;
  __shared__ long long sums[kWarps];
  __shared__ long long range[4];
  __shared__ long long item;
  if (threadIdx.x == 0) {
    range[0] = lower_bound(long_heads, n_long, h0);
    range[1] = lower_bound(long_heads, n_long, h1);
  } else if (threadIdx.x == 32) {
    range[2] = lower_bound(short_heads, n_short, h0);
    range[3] = lower_bound(short_heads, n_short, h1);
  }
  __syncthreads();
  unsigned long long cnt = 0;
  const long long nl = range[1] - range[0];
  for (;;) {
    if (threadIdx.x == 0) item = static_cast<long long>(atomicAdd(out + 1, 1ull));
    __syncthreads();
    const long long it = item;
    __syncthreads();
    if (it >= nl) break;
    cnt += count_head<BlockShape>(long_heads[range[0] + it], off, tg,
                                  sm.block, sums);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ns = range[3] - range[2];
  for (;;) {
    long long it = 0;
    if (lane == 0) {
      it = static_cast<long long>(
          atomicAdd(out + 2, static_cast<unsigned long long>(kShortBatch)));
    }
    it = __shfl_sync(kFull, it, 0);
    if (it >= ns) break;
    const long long end = it + kShortBatch < ns ? it + kShortBatch : ns;
    for (long long j = it; j < end; ++j) {
      cnt += count_head<WarpShape>(short_heads[range[2] + j], off, tg,
                                   sm.warp[warp], nullptr);
    }
  }
  // the block's total, added once
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(kFull, cnt, o);
  __shared__ unsigned long long warp_cnt[kWarps];
  if (lane == 0) warp_cnt[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_cnt[w];
    if (total) atomicAdd(out, total);
  }
}

}  // namespace

extern "C" int tc_count(const void* offsets, const void* targets,
                        const void* long_heads, long long n_long,
                        const void* short_heads, long long n_short,
                        long long h0, long long h1, void* out,
                        void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tc_count_kernel,
                                                        kBlock, 0);
  }
  if (err != cudaSuccess) return (int)err;
  const int grid = sms * (per_sm > 0 ? per_sm : 1);
  tc_count_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      static_cast<const long long*>(offsets), static_cast<const int*>(targets),
      static_cast<const int*>(long_heads), n_long,
      static_cast<const int*>(short_heads), n_short, h0, h1,
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
