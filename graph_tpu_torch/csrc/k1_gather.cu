// K1: per-slot gather, i < m:
//   k1_gather:           contrib[i] = xq[slot_src[i]]               (4-byte)
//   k1_gather_weighted:  v = x[slot_src[i]] + w[i]   (combine "add")
//                        v = x[slot_src[i]] * w[i]   (combine "mul")
//                        contrib[i] = v (f32), or round_half_even(v * 2^30)
//                        as int32 quanta when quantizing.
//
// Replaces graph_tpu/engine/kernels.py:k1_gather (_k1_kernel), the Pallas
// windowed select-gather.  The TPU kernel stages x slices in VMEM and finds
// each slot's source through window, lanemap and pair tables because Mosaic
// has no vector gather; on Hopper the gather is an indexed load, and those
// tables have no role.
//
// k1_gather is the 4-byte form: it serves the int32 sum path (xq = quanta)
// and both min paths (int32 labels for smin_int, f32 bit patterns for
// smin), since a 4-byte gather does not depend on the dtype.  The TPU
// kernel's pair/quad slots (2 or 4 same-destination sources summed or
// min-ed in K1) have no counterpart: the plan holds one source per slot and
// K2 reduces them, with the same bits.
//
// k1_gather_weighted is the f32 form with an edge weight (combine="add" for
// SSSP's relax, "mul" for weighted spmv).  With quantize=1 it also does the
// TPU K2's in-kernel quantize (kernels.py:555-558), so K2 reads int32 quanta
// as on the spmv path: the f32 sum or product is rounded first, then scaled
// by 2^30 (exact, a power of two) and rounded half to even, the same bits
// as the JAX package.  __fadd_rn / __fmul_rn are never contracted into an
// FMA, and __float2int_rn rounds half to even; no fast-math.  Quanta must
// stay inside int32 (|v| < 2), the engine's fixed-point contract.
//
// Bound: bytes.  k1_gather streams slot_src in and contrib out (4 B/slot
// each) and reads xq once (4 B/node): 8*m + 4*n, 554 MB at RMAT scale 22
// (m = 2^26, n = 2^22), 0.165 ms at the data-sheet 3.35 TB/s; at the
// symmetrized WCC shapes (m = 2^27) 1,090 MB, 0.325 ms.  k1_gather_weighted
// adds the weight stream: 12*m + 4*n, 822 MB, 0.245 ms at scale 22.  x is
// 16.8 MB and fits the 50 MB L2, so the random reads of x mostly hit L2;
// the streams are what device memory has to carry.
//
// Design: a grid-stride loop, one thread per slot per step, so neighbouring
// threads stream neighbouring slots; __ldg routes the reads through the
// read-only path.  The grid is one resident wave (8 blocks of 256 threads
// per SM).  Simple and right first: no vector loads yet.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

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

template <bool kMul, bool kQuantize>
__global__ void k1_gather_weighted_kernel(const float* __restrict__ x,
                                          const int32_t* __restrict__ slot_src,
                                          const float* __restrict__ w,
                                          void* __restrict__ contrib,
                                          long long m) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const float xs = __ldg(x + __ldg(slot_src + i));
    const float wi = __ldg(w + i);
    const float v = kMul ? __fmul_rn(xs, wi) : __fadd_rn(xs, wi);
    if constexpr (kQuantize) {
      static_cast<int32_t*>(contrib)[i] =
          __float2int_rn(__fmul_rn(v, 1073741824.0f));  // 2^30
    } else {
      static_cast<float*>(contrib)[i] = v;
    }
  }
}

// One resident wave of kThreads-thread blocks, fewer for small m.
cudaError_t wave_blocks(long long m, int* blocks) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long want = (m + kThreads - 1) / kThreads;
  const long long wave = (long long)sms * 8;
  *blocks = (int)(want < wave ? want : wave);
  return cudaSuccess;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers; slot_src values must index xq.
extern "C" int k1_gather(const void* xq, const void* slot_src, void* contrib,
                         long long m, void* stream) {
  if (m <= 0) return 0;
  int blocks = 0;
  cudaError_t err = wave_blocks(m, &blocks);
  if (err != cudaSuccess) return (int)err;
  k1_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(xq), static_cast<const int32_t*>(slot_src),
      static_cast<int32_t*>(contrib), m);
  return (int)cudaGetLastError();
}

// The same contract; x and w are f32, contrib is int32 when quantize != 0
// and f32 otherwise.  mul != 0 selects x * w, else x + w.
extern "C" int k1_gather_weighted(const void* x, const void* slot_src,
                                  const void* w, void* contrib, long long m,
                                  int mul, int quantize, void* stream) {
  if (m <= 0) return 0;
  int blocks = 0;
  cudaError_t err = wave_blocks(m, &blocks);
  if (err != cudaSuccess) return (int)err;
  const float* xf = static_cast<const float*>(x);
  const int32_t* src = static_cast<const int32_t*>(slot_src);
  const float* wf = static_cast<const float*>(w);
  cudaStream_t s = (cudaStream_t)stream;
  if (mul && quantize) {
    k1_gather_weighted_kernel<true, true>
        <<<blocks, kThreads, 0, s>>>(xf, src, wf, contrib, m);
  } else if (mul) {
    k1_gather_weighted_kernel<true, false>
        <<<blocks, kThreads, 0, s>>>(xf, src, wf, contrib, m);
  } else if (quantize) {
    k1_gather_weighted_kernel<false, true>
        <<<blocks, kThreads, 0, s>>>(xf, src, wf, contrib, m);
  } else {
    k1_gather_weighted_kernel<false, false>
        <<<blocks, kThreads, 0, s>>>(xf, src, wf, contrib, m);
  }
  return (int)cudaGetLastError();
}
