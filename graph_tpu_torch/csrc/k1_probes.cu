// K1 gather probes: how fast a gather out of an on-chip window runs, by
// window size and index layout.  Hopper counterparts of the four Pallas
// kernels of the K1 micro-benchmarks.  The index stream is u16, 128 lanes
// a row (the TPU's vector width); r is the row, j the lane (0-127):
//
//   probe_row_gather     (scripts/perf_k1_lanemap.py:28, depth_probe's kernel)
//       out[r,j] = t[idx[r,j] mod R, j]          t: (R, 128) f32, R <= 128
//   probe_lanemap        (scripts/perf_k1_lanemap.py:65, make_lanemap)
//       lo = st & 127, A = (st >> 8) & 127
//       out[r,j] = x[128*A[r, lo[r,j]] + lo[r,j]]            A < win/128
//   probe_window_gather  (scripts/perf_k1_rowmatch.py:40, make_kernel; its
//                         "rowscan" also scripts/perf_k1_sublane.py:36)
//       rowscan:  out[r,j] = x[idx[r,j]]
//       rowmatch: out[r,j] = x[128*(8*(idx>>10) + r mod 8) + (idx & 127)]
//   probe_sublane        (scripts/perf_k1_sublane.py:36, mode "sublane")
//       hi = idx >> 7, lo = idx & 127
//       out[r,j] = x[128*(8*(hi[r,j]>>3) + (hi[r, lo[r,j]] & 7)) + lo[r,j]]
//
// each for any in-range input (idx < win; A < win/128), bit for bit: the
// kernels move f32 values and do no arithmetic on them.  These are what
// the TPU kernels compute, not what their docstrings say: "rowmatch" is
// x[idx] only on row-matched input, and "sublane" reads the sublane at the
// final lane lo[r,j], so it is x[idx] on about one slot in eight.  An index
// outside the window is clamped to its last element, so no read leaves
// shared memory; the result is then unspecified, as on the TPU.
//
// Bound: bytes.  2 B of index in and 4 B out a slot, and the window or
// table (at most 64 KB) once: 6 B a slot, 403 MB and 0.120 ms at the
// data-sheet 3.35 TB/s for 2^26 slots.  The design:
//   - The window or table is staged in shared memory once per block (16-byte
//     loads when aligned) and every gather reads it there.  Above 48 KB of
//     dynamic shared memory a launch needs cudaFuncSetAttribute; its error
//     is returned, never hidden.
//   - One lane a thread, so a warp reads 64 contiguous bytes of index and
//     writes 128 of output.  The depth probe's table read t[i][j] falls on
//     bank j mod 32 whatever i is: conflict-free at every R (the TPU's
//     sublane gather grows with the operand's depth).
//   - A persistent grid (as many 1,024-thread blocks as fit) walks chunks of
//     32 rows; each thread loads its 4 indices of a chunk before it uses
//     any, so loads are in flight together.
//   - lanemap and sublane need a value from lane lo[r,j] of the same row,
//     and a row spans four warps, so no shuffle reaches it: the chunk's
//     indices go to a shared-memory tile (8 KB) between two block barriers.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 1024;
constexpr int kRowsPerStep = kThreads / kLanes;        // 8
constexpr int kUnroll = 4;
constexpr int kChunkRows = kRowsPerStep * kUnroll;     // 32
constexpr int kTileBytes = kChunkRows * kLanes * 2;    // 8 KB of u16

// Copy src[0:n] (f32) into shared memory, 16 bytes at a time when src is
// aligned, then wait for the whole block.
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      float* dst, int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int k = threadIdx.x; k < n / 4; k += kThreads) d4[k] = __ldg(s4 + k);
    for (int k = (n & ~3) + threadIdx.x; k < n; k += kThreads) {
      dst[k] = __ldg(src + k);
    }
  } else {
    for (int k = threadIdx.x; k < n; k += kThreads) dst[k] = __ldg(src + k);
  }
  __syncthreads();
}

// Every slot of the stream, one lane a thread, in chunks of kChunkRows
// rows: a thread loads its kUnroll indices (rows r0, r0 + 8, ...) first,
// then writes out[r, j] = f(v, r, j, row) for each, where v is the slot's
// index and row the chunk's copy of its row's indices (kRowTile only: a
// block barrier after the copy, and one before the tile is reused).
template <bool kRowTile, typename F>
__device__ __forceinline__ void for_slots(const uint16_t* __restrict__ idx,
                                          float* __restrict__ out,
                                          long long nrows, uint16_t* tile,
                                          F f) {
  const int j = threadIdx.x % kLanes;
  const int r0 = threadIdx.x / kLanes;
  for (long long base = (long long)blockIdx.x * kChunkRows; base < nrows;
       base += (long long)gridDim.x * kChunkRows) {
    uint32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + r0 + u * kRowsPerStep;
      v[u] = r < nrows ? idx[r * kLanes + j] : 0u;
      if constexpr (kRowTile) {
        tile[(r0 + u * kRowsPerStep) * kLanes + j] = (uint16_t)v[u];
      }
    }
    if constexpr (kRowTile) __syncthreads();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tr = r0 + u * kRowsPerStep;
      const long long r = base + tr;
      const uint16_t* row = nullptr;
      if constexpr (kRowTile) row = tile + tr * kLanes;
      if (r < nrows) out[r * kLanes + j] = f(v[u], r, j, row);
    }
    if constexpr (kRowTile) __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    row_gather_kernel(const uint16_t* __restrict__ idx,
                      const float* __restrict__ t, float* __restrict__ out,
                      long long nrows, int rows) {
  extern __shared__ float4 smem[];
  float* ts = reinterpret_cast<float*>(smem);
  stage(t, ts, rows * kLanes);
  const uint32_t depth = (uint32_t)rows;
  for_slots<false>(idx, out, nrows, nullptr,
                   [=](uint32_t v, long long, int j, const uint16_t*) {
                     return ts[(v % depth) * kLanes + j];
                   });
}

__global__ void __launch_bounds__(kThreads, 2)
    lanemap_kernel(const uint16_t* __restrict__ st,
                   const float* __restrict__ x, float* __restrict__ out,
                   long long nrows, int win) {
  extern __shared__ float4 smem[];
  float* xs = reinterpret_cast<float*>(smem);
  uint16_t* tile = reinterpret_cast<uint16_t*>(xs + win);
  stage(x, xs, win);
  const uint32_t last = (uint32_t)win - 1u;
  for_slots<true>(st, out, nrows, tile,
                  [=](uint32_t v, long long, int, const uint16_t* row) {
                    const uint32_t lo = v & 127u;
                    const uint32_t a = ((uint32_t)row[lo] >> 8) & 127u;
                    return xs[min(a * kLanes + lo, last)];
                  });
}

__global__ void __launch_bounds__(kThreads, 2)
    window_gather_kernel(const uint16_t* __restrict__ idx,
                         const float* __restrict__ x,
                         float* __restrict__ out, long long nrows, int win,
                         int rowmatch) {
  extern __shared__ float4 smem[];
  float* xs = reinterpret_cast<float*>(smem);
  stage(x, xs, win);
  const uint32_t last = (uint32_t)win - 1u;
  if (rowmatch) {
    for_slots<false>(idx, out, nrows, nullptr,
                     [=](uint32_t v, long long r, int, const uint16_t*) {
                       const uint32_t k =
                           ((v >> 10) * 8u + (uint32_t)(r & 7)) * kLanes +
                           (v & 127u);
                       return xs[min(k, last)];
                     });
  } else {
    for_slots<false>(idx, out, nrows, nullptr,
                     [=](uint32_t v, long long, int, const uint16_t*) {
                       return xs[min(v, last)];
                     });
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    sublane_kernel(const uint16_t* __restrict__ idx,
                   const float* __restrict__ x, float* __restrict__ out,
                   long long nrows, int win) {
  extern __shared__ float4 smem[];
  float* xs = reinterpret_cast<float*>(smem);
  uint16_t* tile = reinterpret_cast<uint16_t*>(xs + win);
  stage(x, xs, win);
  const uint32_t last = (uint32_t)win - 1u;
  for_slots<true>(idx, out, nrows, tile,
                  [=](uint32_t v, long long, int, const uint16_t* row) {
                    const uint32_t lo = v & 127u;
                    const uint32_t sub = ((uint32_t)row[lo] >> 7) & 7u;
                    return xs[min(((v >> 10) * 8u + sub) * kLanes + lo,
                                  last)];
                  });
}

// A persistent grid of kThreads-thread blocks with `smem` bytes of
// dynamic shared memory each: as many as fit on the card, fewer for small
// streams.  Returns the first CUDA error.
template <typename K, typename... Args>
int launch(K kernel, int smem, long long nrows, void* stream, Args... args) {
  if (nrows <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = (nrows + kChunkRows - 1) / kChunkRows;
  const long long wave = (long long)sms * per_sm;
  const int blocks = (int)(want < wave ? want : wave);
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0
// on success).  Pointers are device pointers: idx/st (nrows, 128) u16,
// out (nrows, 128) f32; t is (rows, 128) f32 with 1 <= rows <= 128; x is
// (win,) f32 with 1 <= win <= 16384.
extern "C" int probe_row_gather(const void* idx, const void* t, void* out,
                                long long nrows, int rows, void* stream) {
  return launch(row_gather_kernel, rows * kLanes * (int)sizeof(float), nrows,
                stream, static_cast<const uint16_t*>(idx),
                static_cast<const float*>(t), static_cast<float*>(out),
                nrows, rows);
}

extern "C" int probe_lanemap(const void* st, const void* x, void* out,
                             long long nrows, int win, void* stream) {
  return launch(lanemap_kernel, win * (int)sizeof(float) + kTileBytes, nrows,
                stream, static_cast<const uint16_t*>(st),
                static_cast<const float*>(x), static_cast<float*>(out), nrows,
                win);
}

// rowmatch != 0 selects "rowmatch", else "rowscan".
extern "C" int probe_window_gather(const void* idx, const void* x, void* out,
                                   long long nrows, int win, int rowmatch,
                                   void* stream) {
  return launch(window_gather_kernel, win * (int)sizeof(float), nrows, stream,
                static_cast<const uint16_t*>(idx),
                static_cast<const float*>(x), static_cast<float*>(out), nrows,
                win, rowmatch);
}

extern "C" int probe_sublane(const void* idx, const void* x, void* out,
                             long long nrows, int win, void* stream) {
  return launch(sublane_kernel, win * (int)sizeof(float) + kTileBytes, nrows,
                stream, static_cast<const uint16_t*>(idx),
                static_cast<const float*>(x), static_cast<float*>(out), nrows,
                win);
}
