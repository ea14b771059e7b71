// K1: per-slot gather of source quanta, contrib[i] = xq[slot_src[i]], i < m.
//
// Replaces graph_tpu/engine/kernels.py:k1_gather (_k1_kernel), the Pallas
// windowed select-gather, on its int32 sum path (combine="none").  The TPU
// kernel stages x slices in VMEM and finds each slot's source through
// window, lanemap and pair tables because Mosaic has no vector gather; on
// Hopper the gather is an indexed load, and those tables have no role.
//
// Bound: bytes.  A call streams slot_src in (4 B/slot) and contrib out
// (4 B/slot), and reads xq once (4 B/node).  At RMAT scale 22 (m = 2^26,
// n = 2^22) that is 8*m + 4*n = 554 MB, 0.165 ms at the data-sheet
// 3.35 TB/s.  xq is 16.8 MB and fits the 50 MB L2, so the random reads of
// xq mostly hit L2; the streams are what device memory has to carry.
//
// Design: a grid-stride loop, one thread per slot per step, so neighbouring
// threads stream neighbouring slots; __ldg routes both reads through the
// read-only path.  The grid is one resident wave (8 blocks of 256 threads
// per SM).  Simple and right first: no vector loads yet.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void k1_gather_kernel(const int32_t* __restrict__ xq,
                                 const int32_t* __restrict__ slot_src,
                                 int32_t* __restrict__ contrib,
                                 long long m) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    contrib[i] = __ldg(xq + __ldg(slot_src + i));
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers; slot_src values must index xq.
extern "C" int k1_gather(const void* xq, const void* slot_src, void* contrib,
                         long long m, void* stream) {
  if (m <= 0) return 0;
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long want = (m + threads - 1) / threads;
  const long long wave = (long long)sms * 8;
  const int blocks = (int)(want < wave ? want : wave);
  k1_gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(xq), static_cast<const int32_t*>(slot_src),
      static_cast<int32_t*>(contrib), m);
  return (int)cudaGetLastError();
}
