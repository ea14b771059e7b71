// The Jacobi tails of PageRank on the plan engine: the n-sized work of an
// iteration outside K1 and K2, in two kernels (i < n):
//   jacobi_quantize: xq[i] = round_half_even(f32(scores[i] * inv[i]) * 2^30)
//                    as int32, the quanta K1 gathers;
//   jacobi_update:   out[i] = fma(d, f32(acc[i]) * 2^-30, base) from K2's
//                    int32 row sums, and err = sum over i of
//                    |out[i] - scores[i]|, the residual the loop tests.
//
// Replaces no pl.pallas_call: graph_tpu leaves this work to XLA, which
// fuses it around the spmv in _page_rank_plan's body
// (graph_tpu/algos/pagerank.py:423-428, the quantize at
// graph_tpu/engine/engine.py:427).  In PyTorch the same op chain ran as
// about eleven kernels a round, each a pass over n-sized vectors.
//
// Bits.  Each step rounds where that op chain rounds: __fmul_rn for
// scores * inv (never contracted into an FMA), the exact product with 2^30,
// __float2int_rn (half to even) for round() and the int32 cast;
// __int2float_rn for the cast of the int32 sums, the exact product with
// 2^-30, one __fmaf_rn for base + d * y (as XLA compiles graph_tpu's update,
// and as PyTorch's fill_(base).add_(y, alpha=d) computes it), __fsub_rn and
// fabsf for each term of the residual.  No fast-math, no flush to zero.
// The residual's sum has an order of its own: each thread adds the terms of
// its vectors of four nodes in double, a block adds its threads' sums in a
// fixed tree, each block stores its sum, and the last block to finish adds
// the blocks' sums in a fixed order and rounds to f32 once.  Which thread
// takes which nodes depends on n and the grid alone (a misaligned pointer
// changes the loads, not the mapping), and the caller gives a grid that is
// a function of n, so the residual has the same bits on every run.
//
// Bound: bytes.  Each kernel reads 8 B a node and writes 4 B: 12 n, 50.3 MB
// at RMAT scale 22 (n = 2^22), 15.0 us at the data-sheet 3.35 TB/s; the
// update also writes 8 B a block.  Design: one vector of four nodes a
// thread and step of a grid-stride loop, 16-byte loads and stores where
// every pointer is 16-byte aligned (scalar ones otherwise, and for a ragged
// last vector).  Inputs are loaded evict-first (__ldcs): K1 and K2 stream
// over half a gigabyte between the two kernels, so no input would still be
// in the L2 when read again, and they do not push out of it what the next
// kernel reads: the quanta K1 gathers, and the new scores.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kScale = 1073741824.0f;               // 2^30
constexpr float kUnscale = 1.0f / 1073741824.0f;      // 2^-30, exact

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ int32_t quantum(float s, float inv) {
  return __float2int_rn(__fmul_rn(__fmul_rn(s, inv), kScale));
}

__device__ __forceinline__ float update(int32_t a, float base, float d) {
  return __fmaf_rn(d, __fmul_rn(__int2float_rn(a), kUnscale), base);
}

// The vectors of four nodes, v < ceil(n / 4), each taken by one thread in a
// grid-stride loop: vec(v) for a whole vector when `aligned`, else one(i)
// for each of its nodes in order.
template <typename V, typename F>
__device__ __forceinline__ void for_vectors(long long n, bool aligned, V vec,
                                            F one) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long nv = (n + 3) >> 2;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < nv;
       v += stride) {
    const long long i = 4 * v;
    if (aligned && i + 4 <= n) {
      vec(v);
    } else {
      for (long long j = i; j < i + 4 && j < n; ++j) one(j);
    }
  }
}

// The block's sum of v, in thread 0, in a fixed order.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0.0;
  if (threadIdx.x < 32) {
    if (threadIdx.x < kThreads / 32) v = warp_sums[threadIdx.x];
    for (int o = kThreads / 64; o > 0; o >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, o);
    }
  }
  __syncthreads();  // warp_sums is free again
  return v;
}

__global__ void __launch_bounds__(kThreads)
    jacobi_quantize_kernel(const float* __restrict__ scores,
                           const float* __restrict__ inv,
                           int32_t* __restrict__ xq, long long n) {
  const bool aligned = aligned16(scores) && aligned16(inv) && aligned16(xq);
  for_vectors(
      n, aligned,
      [=](long long v) {
        const float4 s = __ldcs(reinterpret_cast<const float4*>(scores) + v);
        const float4 w = __ldcs(reinterpret_cast<const float4*>(inv) + v);
        reinterpret_cast<int4*>(xq)[v] =
            make_int4(quantum(s.x, w.x), quantum(s.y, w.y), quantum(s.z, w.z),
                      quantum(s.w, w.w));
      },
      [=](long long i) { xq[i] = quantum(__ldcs(scores + i), __ldcs(inv + i)); });
}

// work: gridDim.x block sums (double), then the ticket (an unsigned int in
// the last 8 bytes), 0 at entry; the last block sets it to 0 again.
__global__ void __launch_bounds__(kThreads)
    jacobi_update_kernel(const int32_t* __restrict__ acc,
                         const float* __restrict__ scores,
                         float* __restrict__ out, long long n, float base,
                         float d, double* __restrict__ work,
                         float* __restrict__ err) {
  const bool aligned = aligned16(acc) && aligned16(scores) && aligned16(out);
  double part = 0.0;
  for_vectors(
      n, aligned,
      [&](long long v) {
        const int4 a = __ldcs(reinterpret_cast<const int4*>(acc) + v);
        const float4 s = __ldcs(reinterpret_cast<const float4*>(scores) + v);
        const float4 y = make_float4(update(a.x, base, d), update(a.y, base, d),
                                     update(a.z, base, d), update(a.w, base, d));
        reinterpret_cast<float4*>(out)[v] = y;
        part += fabsf(__fsub_rn(y.x, s.x));
        part += fabsf(__fsub_rn(y.y, s.y));
        part += fabsf(__fsub_rn(y.z, s.z));
        part += fabsf(__fsub_rn(y.w, s.w));
      },
      [&](long long i) {
        const float y = update(__ldcs(acc + i), base, d);
        out[i] = y;
        part += fabsf(__fsub_rn(y, __ldcs(scores + i)));
      });
  part = block_sum(part);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(work + gridDim.x);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    work[blockIdx.x] = part;
    __threadfence();  // the sum is seen before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double total = 0.0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    total += __ldcg(work + b);
  }
  total = block_sum(total);
  if (threadIdx.x == 0) {
    *err = __double2float_rn(total);
    *ticket = 0u;
  }
}

}  // namespace

// Each launches on `stream` with `blocks` blocks of 256 threads and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers to n
// elements (err: one f32; work: blocks + 1 doubles, zeroed before its first
// use).
extern "C" int jacobi_quantize(const void* scores, const void* inv, void* xq,
                               long long n, int blocks, void* stream) {
  if (n <= 0) return 0;
  jacobi_quantize_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(scores), static_cast<const float*>(inv),
      static_cast<int32_t*>(xq), n);
  return (int)cudaGetLastError();
}

extern "C" int jacobi_update(const void* acc, const void* scores, void* out,
                             long long n, float base, float d, void* work,
                             void* err, int blocks, void* stream) {
  if (n <= 0) return 0;
  jacobi_update_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(acc), static_cast<const float*>(scores),
      static_cast<float*>(out), n, base, d, static_cast<double*>(work),
      static_cast<float*>(err));
  return (int)cudaGetLastError();
}
