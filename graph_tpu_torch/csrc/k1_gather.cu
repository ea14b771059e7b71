// K1: per-slot gather, i < m:
//   k1_gather:           contrib[i] = xq[slot_src[i]]               (4-byte)
//   k1_gather_weighted:  v = x[slot_src[i]] + w[i]   (combine "add")
//                        v = x[slot_src[i]] * w[i]   (combine "mul")
//                        contrib[i] = v (f32), or round_half_even(v * 2^30)
//                        as int32 quanta when quantizing.
//
// Replaces graph_tpu/engine/kernels.py:253 (k1_gather, its _k1_kernel), the
// Pallas windowed select-gather.  The TPU kernel stages x slices in VMEM and
// finds each slot's source through window, lanemap and pair tables because
// Mosaic has no vector gather; on Hopper the gather is an indexed load, and
// those tables have no role.  The VMEM-staged slice survives in Hopper form
// as the shared-memory window below.
//
// k1_gather is the 4-byte form: it serves the int32 sum path (xq = quanta)
// and both min paths (int32 labels for smin_int, f32 bit patterns for
// smin), since a 4-byte gather does not depend on the dtype.  The TPU
// kernel's pair/quad slots (2 or 4 same-destination sources summed or
// min-ed in K1) have no counterpart: the plan holds one source per slot and
// K2 reduces them, with the same bits (integer sum and min do not depend on
// order).
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
// adds the weight stream: 12*m + 4*n, 822 MB, 0.245 ms at scale 22.
//
// What holds it back is not the streams but the L2: x (16.8 MB) fits the
// 50 MB L2, yet every random 4-byte gather costs a 32-byte L2 sector read,
// 2.15 GB per call at m = 2^26.  The design:
//   - Vector streams.  A persistent grid (as many blocks as fit on the SMs)
//     in which each thread takes two 16-byte vectors of slot_src per step
//     (8 slots, 8 independent gathers in flight), loads w as float4, and
//     stores contrib as 16-byte vectors.  The streams bypass the L2's
//     normal retention (evict-first loads and stores), so they do not push
//     x out of it.  When a pointer is not 16-byte aligned (a tensor view),
//     the same kernel runs a scalar loop instead; a ragged tail of m % 4
//     slots is scalar.
//   - A shared-memory window of the hottest sources.  On entry each block
//     copies x[0:h] into shared memory (16-byte loads), and a gather with
//     src < h reads it there instead of the L2.  The degree-relabeled plans
//     number sources by descending out-degree, so the first 49,152 ids (192
//     KB, one block per SM) are the sources of 60% of all slots at scale
//     22.  The window is the caller's argument (0 turns it off): the engine
//     passes it for relabeled plans only, since a plan on node ids has no
//     hot prefix.  Random shared-memory reads conflict on banks (32 random
//     addresses, about 3-way expected), still cheaper than an L2 round trip;
//     a window much above 192 KB leaves the L1 too little room for the
//     next-hottest sources and is slower again (PERF.md, the probe).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;

// Copy x[0:h] into the block's window, 16 bytes at a time when x is
// aligned, then wait for the whole block.
__device__ __forceinline__ void stage_window(const int32_t* __restrict__ x,
                                             int32_t* win, int h) {
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int4* xv = reinterpret_cast<const int4*>(x);
    int4* wv = reinterpret_cast<int4*>(win);
    for (int k = threadIdx.x; k < h / 4; k += kThreads) wv[k] = __ldg(xv + k);
    for (int k = (h & ~3) + threadIdx.x; k < h; k += kThreads) {
      win[k] = __ldg(x + k);
    }
  } else {
    for (int k = threadIdx.x; k < h; k += kThreads) win[k] = __ldg(x + k);
  }
  __syncthreads();
}

__device__ __forceinline__ int32_t fetch(const int32_t* __restrict__ x,
                                         const int32_t* win, int h, int s) {
  return s < h ? win[s] : __ldg(x + s);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The slots of the grid: pairs of 16-byte vectors per thread and step,
// then the m % 4 tail; or, unless every stream is 16-byte aligned, one
// scalar slot per thread and step.  vec4(src4, v) gives contrib's vector v
// (slots 4v..4v+3) from their sources; one(src, i) gives contrib[i].
template <typename V, typename F>
__device__ __forceinline__ void for_slots(const int32_t* __restrict__ slot_src,
                                          int32_t* __restrict__ contrib,
                                          long long m, bool vec, V vec4,
                                          F one) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  long long tail = 0;
  if (vec) {
    const long long nv = m >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(slot_src);
    int4* o4 = reinterpret_cast<int4*>(contrib);
    long long v = tid;
    for (; v + stride < nv; v += 2 * stride) {
      const int4 a = __ldcs(s4 + v);
      const int4 b = __ldcs(s4 + v + stride);
      const int4 ra = vec4(a, v);
      const int4 rb = vec4(b, v + stride);
      __stcs(o4 + v, ra);
      __stcs(o4 + v + stride, rb);
    }
    if (v < nv) __stcs(o4 + v, vec4(__ldcs(s4 + v), v));
    tail = 4 * nv;
  }
  for (long long i = tail + tid; i < m; i += stride) {
    contrib[i] = one(__ldcs(slot_src + i), i);
  }
}

__global__ void __launch_bounds__(kThreads)
    k1_gather_kernel(const int32_t* __restrict__ xq,
                     const int32_t* __restrict__ slot_src,
                     int32_t* __restrict__ contrib, long long m, int h) {
  extern __shared__ int4 smem[];
  int32_t* win = reinterpret_cast<int32_t*>(smem);
  stage_window(xq, win, h);
  const bool vec = aligned16(slot_src) && aligned16(contrib);
  for_slots(
      slot_src, contrib, m, vec,
      [=](int4 s, long long) {
        return make_int4(fetch(xq, win, h, s.x), fetch(xq, win, h, s.y),
                         fetch(xq, win, h, s.z), fetch(xq, win, h, s.w));
      },
      [=](int s, long long) { return fetch(xq, win, h, s); });
}

// x op w in f32, rounded once (no FMA), as f32 bits or as int32 quanta.
template <bool kMul, bool kQuantize>
__device__ __forceinline__ int32_t weigh(int32_t xbits, float wi) {
  const float xs = __int_as_float(xbits);
  const float v = kMul ? __fmul_rn(xs, wi) : __fadd_rn(xs, wi);
  if constexpr (kQuantize) {
    return __float2int_rn(__fmul_rn(v, 1073741824.0f));  // 2^30
  } else {
    return __float_as_int(v);
  }
}

template <bool kMul, bool kQuantize>
__global__ void __launch_bounds__(kThreads)
    k1_gather_weighted_kernel(const float* __restrict__ x,
                              const int32_t* __restrict__ slot_src,
                              const float* __restrict__ w,
                              int32_t* __restrict__ contrib, long long m,
                              int h) {
  extern __shared__ int4 smem[];
  int32_t* win = reinterpret_cast<int32_t*>(smem);
  const int32_t* xb = reinterpret_cast<const int32_t*>(x);
  stage_window(xb, win, h);
  const bool vec = aligned16(slot_src) && aligned16(contrib) && aligned16(w);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  for_slots(
      slot_src, contrib, m, vec,
      [=](int4 s, long long v) {
        const float4 wv = __ldcs(w4 + v);
        return make_int4(weigh<kMul, kQuantize>(fetch(xb, win, h, s.x), wv.x),
                         weigh<kMul, kQuantize>(fetch(xb, win, h, s.y), wv.y),
                         weigh<kMul, kQuantize>(fetch(xb, win, h, s.z), wv.z),
                         weigh<kMul, kQuantize>(fetch(xb, win, h, s.w), wv.w));
      },
      [=](int s, long long i) {
        return weigh<kMul, kQuantize>(fetch(xb, win, h, s), __ldcs(w + i));
      });
}

// As many kThreads-thread blocks as fit on the card with `smem` bytes of
// window each (fewer for small m).
template <typename K>
cudaError_t persistent_grid(K kernel, int smem, long long m, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long want = (m + 4LL * kThreads - 1) / (4LL * kThreads);
  const long long wave = (long long)sms * per_sm;
  *blocks = (int)(want < wave ? want : wave);
  return cudaSuccess;
}

template <typename K, typename... Args>
int launch(K kernel, long long m, int h, void* stream, Args... args) {
  const int smem = h * (int)sizeof(int32_t);
  int blocks = 0;
  cudaError_t err = persistent_grid(kernel, smem, m, &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(args..., m, h);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers; slot_src values must index xq; h is the
// window (0 <= h <= the number of sources, h * 4 bytes of shared memory).
extern "C" int k1_gather(const void* xq, const void* slot_src, void* contrib,
                         long long m, int h, void* stream) {
  if (m <= 0) return 0;
  return launch(k1_gather_kernel, m, h, stream,
                static_cast<const int32_t*>(xq),
                static_cast<const int32_t*>(slot_src),
                static_cast<int32_t*>(contrib));
}

// The same contract; x and w are f32, contrib is int32 when quantize != 0
// and f32 otherwise.  mul != 0 selects x * w, else x + w.
extern "C" int k1_gather_weighted(const void* x, const void* slot_src,
                                  const void* w, void* contrib, long long m,
                                  int h, int mul, int quantize,
                                  void* stream) {
  if (m <= 0) return 0;
  const float* xf = static_cast<const float*>(x);
  const int32_t* src = static_cast<const int32_t*>(slot_src);
  const float* wf = static_cast<const float*>(w);
  int32_t* out = static_cast<int32_t*>(contrib);
  if (mul && quantize) {
    return launch(k1_gather_weighted_kernel<true, true>, m, h, stream, xf,
                  src, wf, out);
  }
  if (mul) {
    return launch(k1_gather_weighted_kernel<true, false>, m, h, stream, xf,
                  src, wf, out);
  }
  if (quantize) {
    return launch(k1_gather_weighted_kernel<false, true>, m, h, stream, xf,
                  src, wf, out);
  }
  return launch(k1_gather_weighted_kernel<false, false>, m, h, stream, xf,
                src, wf, out);
}
