// K2 stream-floor probes: what it costs to stream K2's inputs, section by
// section, into a per-destination-block output, with the reduction taken
// out.  Hopper counterparts of the eight Pallas sites of the K2 IO
// micro-benchmarks:
//
//   probe_sec_stream      int32 out; replaces
//       scripts/perf_k2_io.py:102 (run_variant: _sink4_kernel,
//           _sink4_nout_kernel, _sink1_kernel) and :120 (main's copy),
//       scripts/perf_k2_io2.py:73 (run_variant), perf_k2_io3.py:122 (mk),
//       perf_k2_io4.py:108 (mk_multipass) and :145 (mk_onepass),
//       perf_k2_io5.py:103 (mk)
//   probe_sec_stream_f32  f32 out; replaces scripts/perf_k2_streams.py:69
//                         (bench)
//
// The function.  v is (rows, 128) f32; a step k computes on the h rows of v
// from row0[k] and adds into out block ob[k] (h rows of 128), which it
// first sets to 0 when zero[k]; the steps run in order, `passes` times.
// probe_sec_stream adds, in int32 that wraps,
//     T(v[rows]) + each full side's [rows] + each touched side's [row0, 0]
// with T = trunc (__float2int_rz), round (__float2int_rn of v * 2^30, half
// to even) or bitcast (the f32 bits); sides are u16 (widened) or int32.
// probe_sec_stream_f32 adds acc = ((v + f(t0)) + f(t1)) + ..., f(t) =
// float(int32(t)) of each touched side, with __fadd_rn throughout, so its
// bits are the TPU kernel's sequential f32 adds.  A block that no step
// zeroes starts from `init` (the TPU leaves it undefined; interpret mode
// fills it with INT32_MIN or NaN), and a block no step touches is `init`.
//
// The schedule.  The host groups the steps by out block, in grid order,
// and resolves the zeroes: a block's chain over all passes is cut at its
// last zero.  What comes before is dead (its value is overwritten), yet it
// is read all the same, as the TPU read it; what comes after is live.  The
// host cuts both into pieces of at most 32 steps (the f32 live chain stays
// whole: its adds must stay in order).  A CTA takes one 8-row tile of one
// piece: each thread owns 4 consecutive lanes, keeps their running sums in
// registers over the piece's steps, and writes once at the end: a block
// with one live piece stores it; a block with several adds each with
// atomicAdd into the wrapper's init-filled out (wrapped int32 sums add in
// any order, exactly; the first piece of a zeroed block adds -init).  Dead
// pieces keep their loads by a store to a scratch word that only a
// particular sum would make.  So the TPU's sequential grid is reproduced
// bit for bit, never-zeroed blocks that accumulate across passes
// included; the TPU wrote its out block every step, the port writes once.
//
// Bound: bytes.  Each step reads its h x 128 rows of v (4 B a slot) and of
// each full side (2 B), one scalar of each touched side, and each out
// block is written once; at 3.35 TB/s.  The design for it: 16-byte
// streaming loads of v (8 bytes of a u16 side), four steps' loads issued
// before their adds, pieces short enough that a hub block's long chain is
// spread over many SMs.  A touched scalar is one load a warp (a broadcast).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kVec = 4;                            // lanes a thread
constexpr int kTileRows = kThreads * kVec / kLanes;  // 8
constexpr int kUnroll = 4;                         // steps in flight
constexpr int kMaxSides = 5;
constexpr uint32_t kSinkKey = 0x9e3779b9u;

enum Mode { kTrunc = 0, kRound = 1, kBitcast = 2 };
enum Kind { kDead = 0, kStore = 1, kAdd = 2 };

struct Sides {
  const void* p[kMaxSides];
  int is32;  // bit s: side s is int32, else u16
  int wide;  // bit s: side s is 640 lanes wide (touched only)
};

// One piece of a block's chain: the block, where its row0 list starts in
// `chain`, its step count, and how its sums reach the block.
struct Piece {
  long long block;
  long long off;
  int count;
  int kind;
  bool zeroed;  // the block's chain has a zero (so the live part starts at 0)
  bool first;   // the first live piece of the block
};

__device__ __forceinline__ Piece piece_at(const long long* pieces,
                                          long long p) {
  const long long* pc = pieces + 4 * p;
  const long long word = pc[3];
  return {pc[0], pc[1], (int)pc[2], (int)(word & 15), ((word >> 4) & 1) != 0,
          ((word >> 5) & 1) != 0};
}

template <int kMode>
__device__ __forceinline__ uint32_t quantize(float x) {
  if constexpr (kMode == kTrunc) {
    return (uint32_t)__float2int_rz(x);
  } else if constexpr (kMode == kRound) {
    return (uint32_t)__float2int_rn(__fmul_rn(x, 1073741824.0f));
  } else {
    return (uint32_t)__float_as_int(x);
  }
}

// Side s at [row, 0], as an int32 (u16 zero-extended).
__device__ __forceinline__ uint32_t touch(const Sides& s, int i,
                                          long long row) {
  const long long w = ((s.wide >> i) & 1) ? 5 * kLanes : kLanes;
  if ((s.is32 >> i) & 1) {
    return (uint32_t)__ldg(static_cast<const int*>(s.p[i]) + row * w);
  }
  return (uint32_t)__ldg(static_cast<const uint16_t*>(s.p[i]) + row * w);
}

// Side s at [row, lane .. lane + 3] added into add[].
__device__ __forceinline__ void add_full(const Sides& s, int i, long long row,
                                         int lane, uint32_t* add) {
  if ((s.is32 >> i) & 1) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(
        static_cast<const int*>(s.p[i]) + row * kLanes + lane));
    add[0] += (uint32_t)q.x;
    add[1] += (uint32_t)q.y;
    add[2] += (uint32_t)q.z;
    add[3] += (uint32_t)q.w;
  } else {
    const uint2 q = __ldcs(reinterpret_cast<const uint2*>(
        static_cast<const uint16_t*>(s.p[i]) + row * kLanes + lane));
    add[0] += q.x & 0xffffu;
    add[1] += q.x >> 16;
    add[2] += q.y & 0xffffu;
    add[3] += q.y >> 16;
  }
}

__device__ __forceinline__ float4 load_v(const float* v, long long row,
                                         int lane) {
  return __ldcs(reinterpret_cast<const float4*>(v + row * kLanes + lane));
}

template <int kMode, int kNs, bool kFull>
__global__ void __launch_bounds__(kThreads)
    sec_stream_kernel(const float* __restrict__ v, Sides sides,
                      uint32_t* __restrict__ out,
                      const long long* __restrict__ pieces,
                      const long long* __restrict__ chain,
                      uint32_t* __restrict__ sink, int h, uint32_t init) {
  const int tiles = h / kTileRows;
  const Piece pc = piece_at(pieces, blockIdx.x / tiles);
  const int e = (blockIdx.x % tiles) * kTileRows * kLanes + threadIdx.x * kVec;
  const int row = e / kLanes;
  const int lane = e % kLanes;
  uint32_t start = 0;
  if (pc.kind == kStore) start = pc.zeroed ? 0u : init;
  if (pc.kind == kAdd && pc.first && pc.zeroed) start = 0u - init;
  uint32_t acc[kVec] = {start, start, start, start};
  for (int i = 0; i < pc.count; i += kUnroll) {
    long long r0[kUnroll];
    float4 x[kUnroll];
    uint32_t add[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      r0[u] = i + u < pc.count ? __ldg(chain + pc.off + i + u) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r0[u] < 0) continue;
      x[u] = load_v(v, r0[u] + row, lane);
      uint32_t t = 0;
#pragma unroll
      for (int s = 0; s < kNs; ++s) {
        if constexpr (!kFull) t += touch(sides, s, r0[u]);
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) add[u][k] = t;
#pragma unroll
      for (int s = 0; s < kNs; ++s) {
        if constexpr (kFull) add_full(sides, s, r0[u] + row, lane, add[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r0[u] < 0) continue;
      acc[0] += quantize<kMode>(x[u].x) + add[u][0];
      acc[1] += quantize<kMode>(x[u].y) + add[u][1];
      acc[2] += quantize<kMode>(x[u].z) + add[u][2];
      acc[3] += quantize<kMode>(x[u].w) + add[u][3];
    }
  }
  uint32_t* o = out + pc.block * (long long)h * kLanes + e;
  if (pc.kind == kStore) {
    *reinterpret_cast<uint4*>(o) = make_uint4(acc[0], acc[1], acc[2], acc[3]);
  } else if (pc.kind == kAdd) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) atomicAdd(o + k, acc[k]);
  } else if ((acc[0] ^ acc[1] ^ acc[2] ^ acc[3]) == kSinkKey) {
    *sink = acc[0];
  }
}

template <int kNs>
__global__ void __launch_bounds__(kThreads)
    sec_stream_f32_kernel(const float* __restrict__ v, Sides sides,
                          float* __restrict__ out,
                          const long long* __restrict__ pieces,
                          const long long* __restrict__ chain,
                          uint32_t* __restrict__ sink, int h, float init) {
  const int tiles = h / kTileRows;
  const Piece pc = piece_at(pieces, blockIdx.x / tiles);
  const int e = (blockIdx.x % tiles) * kTileRows * kLanes + threadIdx.x * kVec;
  const int row = e / kLanes;
  const int lane = e % kLanes;
  const float start = (pc.kind == kStore && !pc.zeroed) ? init : 0.0f;
  float acc[kVec] = {start, start, start, start};
  for (int i = 0; i < pc.count; i += kUnroll) {
    long long r0[kUnroll];
    float4 x[kUnroll];
    float t[kUnroll][kNs > 0 ? kNs : 1];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      r0[u] = i + u < pc.count ? __ldg(chain + pc.off + i + u) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r0[u] < 0) continue;
      x[u] = load_v(v, r0[u] + row, lane);
#pragma unroll
      for (int s = 0; s < kNs; ++s) {
        t[u][s] = __int2float_rn((int)touch(sides, s, r0[u]));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r0[u] < 0) continue;
      float a[kVec] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
#pragma unroll
        for (int s = 0; s < kNs; ++s) a[k] = __fadd_rn(a[k], t[u][s]);
        acc[k] = __fadd_rn(acc[k], a[k]);
      }
    }
  }
  float* o = out + pc.block * (long long)h * kLanes + e;
  if (pc.kind == kStore) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else if ((__float_as_uint(acc[0]) ^ __float_as_uint(acc[1]) ^
              __float_as_uint(acc[2]) ^ __float_as_uint(acc[3])) ==
             kSinkKey) {
    *sink = __float_as_uint(acc[0]);
  }
}

template <typename K, typename... Args>
int launch(K kernel, long long npieces, int h, void* stream, Args... args) {
  const long long grid = npieces * (h / kTileRows);
  if (grid <= 0) return 0;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int kMode, bool kFull>
int int_by_sides(int ns, long long npieces, int h, void* stream,
                 const float* v, const Sides& s, uint32_t* out,
                 const long long* pieces, const long long* chain,
                 uint32_t* sink, uint32_t init) {
#define K2P_CASE(N)                                                        \
  case N:                                                                  \
    return launch(sec_stream_kernel<kMode, N, kFull>, npieces, h, stream, v, \
                  s, out, pieces, chain, sink, h, init);
  switch (ns) {
    K2P_CASE(0)
    K2P_CASE(1)
    K2P_CASE(2)
    K2P_CASE(3)
    K2P_CASE(4)
    K2P_CASE(5)
  }
#undef K2P_CASE
  return (int)cudaErrorInvalidValue;
}

template <int kMode>
int int_by_read(int full, int ns, long long npieces, int h, void* stream,
                const float* v, const Sides& s, uint32_t* out,
                const long long* pieces, const long long* chain,
                uint32_t* sink, uint32_t init) {
  return full ? int_by_sides<kMode, true>(ns, npieces, h, stream, v, s, out,
                                          pieces, chain, sink, init)
              : int_by_sides<kMode, false>(ns, npieces, h, stream, v, s, out,
                                           pieces, chain, sink, init);
}

Sides sides_of(const void* s0, const void* s1, const void* s2, const void* s3,
               const void* s4, int is32, int wide) {
  return {{s0, s1, s2, s3, s4}, is32, wide};
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0
// on success; nothing is launched for npieces == 0).  Pointers are device
// pointers: v (rows, 128) f32, 16-byte aligned; s0..s4 the first nsides
// sides ((rows, 128) or, touched only, (rows, 640); u16 or, where bit s of
// is32 is set, int32; full sides 8- or 16-byte aligned); out
// (nout * h, 128), filled with init by the caller; pieces (npieces, 4)
// int64 [block, chain offset, steps, kind | zeroed << 4 | first << 5];
// chain the row0 of every piece's steps, int64; sink one scratch word.
// h is a multiple of 8.  mode: 0 trunc, 1 round, 2 bitcast; full != 0
// reads every side in full, else by touch.
extern "C" int probe_sec_stream(const void* v, const void* s0, const void* s1,
                                const void* s2, const void* s3, const void* s4,
                                void* out, const void* pieces,
                                const void* chain, void* sink,
                                long long npieces, int h, int nsides,
                                int mode, int full, int is32, int wide,
                                int init, void* stream) {
  const Sides s = sides_of(s0, s1, s2, s3, s4, is32, wide);
  const float* vf = static_cast<const float*>(v);
  uint32_t* o = static_cast<uint32_t*>(out);
  const long long* pc = static_cast<const long long*>(pieces);
  const long long* ch = static_cast<const long long*>(chain);
  uint32_t* sk = static_cast<uint32_t*>(sink);
  const uint32_t i0 = (uint32_t)init;
  switch (mode) {
    case kTrunc:
      return int_by_read<kTrunc>(full, nsides, npieces, h, stream, vf, s, o,
                                 pc, ch, sk, i0);
    case kRound:
      return int_by_read<kRound>(full, nsides, npieces, h, stream, vf, s, o,
                                 pc, ch, sk, i0);
    case kBitcast:
      return int_by_read<kBitcast>(full, nsides, npieces, h, stream, vf, s, o,
                                   pc, ch, sk, i0);
  }
  return (int)cudaErrorInvalidValue;
}

// As probe_sec_stream, every side touched; out is f32 and init_bits the
// bits of its f32 starting value.  Every block has one live piece.
extern "C" int probe_sec_stream_f32(const void* v, const void* s0,
                                    const void* s1, const void* s2,
                                    const void* s3, const void* s4, void* out,
                                    const void* pieces, const void* chain,
                                    void* sink, long long npieces, int h,
                                    int nsides, int is32, int wide,
                                    int init_bits, void* stream) {
  const Sides s = sides_of(s0, s1, s2, s3, s4, is32, wide);
  const float* vf = static_cast<const float*>(v);
  float* o = static_cast<float*>(out);
  const long long* pc = static_cast<const long long*>(pieces);
  const long long* ch = static_cast<const long long*>(chain);
  uint32_t* sk = static_cast<uint32_t*>(sink);
  float i0;
  std::memcpy(&i0, &init_bits, sizeof i0);
#define K2P_F32_CASE(N)                                                   \
  case N:                                                                 \
    return launch(sec_stream_f32_kernel<N>, npieces, h, stream, vf, s, o, \
                  pc, ch, sk, h, i0);
  switch (nsides) {
    K2P_F32_CASE(0)
    K2P_F32_CASE(1)
    K2P_F32_CASE(2)
    K2P_F32_CASE(3)
    K2P_F32_CASE(4)
    K2P_F32_CASE(5)
  }
#undef K2P_F32_CASE
  return (int)cudaErrorInvalidValue;
}
