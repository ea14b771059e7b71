// K2: per-destination reduction of slot contributions, for d < n, over the
// row contrib[indptr[d] : indptr[d+1]]:
//   k2_reduce:      y[d] = sum mod 2^32 (int32 fixed-point quanta); empty
//                   rows give 0;
//   k2_reduce_min:  y[d] = min(fill, min of the row) as signed int32; empty
//                   rows give fill.
//
// Replaces graph_tpu/engine/kernels.py:k2_reduce (_k2_kernel, in both its
// legacy and its scan-depth-classed form), op="sum", "min" and "imin".  The
// TPU kernel routes each 65,536-slot section through a Benes network into
// destination order and runs a segmented scan in VMEM; here the plan
// already stores slots in destination order with row offsets, so the
// reduction reads each row's run directly.  Routes and scan classes have no
// role on Hopper.
//
// One min kernel serves both min ops; the wrapper passes the fill:
//   op="imin" (int32 labels):      fill 2^31-1 (kernels.py:382);
//   op="min"  (f32 bit patterns):  fill 2137108966, the bits of 3e38
//                                  (kernels.py:381).
// For nonnegative f32 values, signed int32 order of the bit patterns is
// IEEE order, so an integer min computes the f32 min; the TPU kernel merges
// its sections the same way (kernels.py:593-600), and its accumulator
// starts at the fill, so a row's min is never above the fill there either.
//
// Bound: bytes.  A call reads contrib (4 B/slot) and indptr (8 B/node) and
// writes y (4 B/node): 4*m + 12*n, 319 MB at RMAT scale 22 (0.095 ms at the
// data-sheet 3.35 TB/s) and 587 MB at the symmetrized WCC shapes (m = 2^27,
// 0.175 ms); m integer additions or compares are far below any compute
// limit.
//
// Design: one warp per destination row in a grid-stride loop over rows;
// the warp's lanes stride over the row, and a shuffle tree combines the
// lanes.  The sum is kept in uint32_t: unsigned addition wraps mod 2^32,
// which is the engine's fixed-point contract, while signed overflow is
// undefined in C++.  The result is reinterpreted as int32 (two's
// complement).  Known imbalance: power-law hub rows hold 10^5 slots and
// more, and one warp walks each of them alone.  Recorded, not fixed, in
// this version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps, 8 rows in flight per block

__global__ void k2_reduce_kernel(const int32_t* __restrict__ contrib,
                                 const long long* __restrict__ indptr,
                                 int32_t* __restrict__ y, long long n) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long row = warp; row < n; row += nwarps) {
    const long long lo = __ldg(indptr + row);
    const long long hi = __ldg(indptr + row + 1);
    uint32_t acc = 0u;
    for (long long j = lo + lane; j < hi; j += 32) {
      acc += static_cast<uint32_t>(__ldg(contrib + j));
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) y[row] = static_cast<int32_t>(acc);
  }
}

__global__ void k2_reduce_min_kernel(const int32_t* __restrict__ contrib,
                                     const long long* __restrict__ indptr,
                                     int32_t* __restrict__ y, long long n,
                                     int32_t fill) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long row = warp; row < n; row += nwarps) {
    const long long lo = __ldg(indptr + row);
    const long long hi = __ldg(indptr + row + 1);
    int32_t acc = fill;
    for (long long j = lo + lane; j < hi; j += 32) {
      acc = min(acc, __ldg(contrib + j));
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc = min(acc, __shfl_down_sync(0xffffffffu, acc, off));
    }
    if (lane == 0) y[row] = acc;
  }
}

// One resident wave of kThreads-thread blocks, fewer for small n.
cudaError_t wave_blocks(long long n, int* blocks) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (n + 7) / 8;
  const long long wave = (long long)sms * 8;
  *blocks = (int)(want < wave ? want : wave);
  return cudaSuccess;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// indptr holds n + 1 nondecreasing offsets into contrib.
extern "C" int k2_reduce(const void* contrib, const void* indptr, void* y,
                         long long n, void* stream) {
  if (n <= 0) return 0;
  int blocks = 0;
  cudaError_t err = wave_blocks(n, &blocks);
  if (err != cudaSuccess) return (int)err;
  k2_reduce_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(contrib),
      static_cast<const long long*>(indptr), static_cast<int32_t*>(y), n);
  return (int)cudaGetLastError();
}

// The same contract, with the row min (capped at fill) instead of the sum.
extern "C" int k2_reduce_min(const void* contrib, const void* indptr, void* y,
                             long long n, int fill, void* stream) {
  if (n <= 0) return 0;
  int blocks = 0;
  cudaError_t err = wave_blocks(n, &blocks);
  if (err != cudaSuccess) return (int)err;
  k2_reduce_min_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(contrib),
      static_cast<const long long*>(indptr), static_cast<int32_t*>(y), n,
      static_cast<int32_t>(fill));
  return (int)cudaGetLastError();
}
