// K2 stage probes: the TPU's K2 section program (route 1, segmented scan,
// route 2) and its stage-by-stage variants, run on Hopper.  Counterparts
// of the seven Pallas sites of the K2 stage-attribution and transpose
// micro-benchmarks, in two sources:
//
//   probe_sec_route  sections of 512 rows x 128 lanes, a cluster of 4
//                    blocks each; replaces scripts/perf_k2_stages.py:66
//                    (bench: k_io, k_route, k_mxucsum, k_segscan,
//                    k_compact), perf_k2v2_stages.py:86 (variant_kernel),
//                    perf_k2_route_ops.py:113 (variant_kernel) and :167
//                    (the inline C stage), and perf_transpose.py:33 (mk:
//                    copy, t512x2, taa512)
//   probe_sec128     sections of 128 rows (k2_sec128.cu, a design of its
//                    own); replaces scripts/perf_k2_sec128.py:159 (k2_128)
//                    and :218 (k2_quad, four outputs), and
//                    perf_transpose.py:33's t128x8 and taa128x4
//
// The function.  A variant is a program of stages run on each section of
// its steps, then the step's epilogue (below).  A section's state is an
// (R, 128) int32 array X, as the TPU kernel holds it: in the V layout (row
// r of the section) or, after a transpose T, in the Y layout (row i = k*G
// + a holds column k of row group a: y[k*G + a, j] = v[a*128 + j, k],
// G = R / 128).  Stages (w a side stream at the state's own rows):
//   LOAD      X = Q(v[rows]), Q trunc (toward zero), round (v * 2^30, half
//             to even) or the int32 bits; f32 values at a set pad bit (bit
//             15 of a side) first made 0.0
//   GATHER    X[i, l] = X[i, (w[i, l] >> s) & 127], or X[i, (l + s) & 127]
//   T, TI     transpose to the Y layout and back
//   C         X[i, j] = X[(i & ~3) | ((w[i, j] >> 7) & 3), j]    (Y layout)
//   MASK      X = bit 15 of w ? X : 0
//   SCAN      the masked log-shift segmented sum of the TPU kernels, ss =
//             w: lane steps sh in 1, 2, .. (L of them), X[r, l] +=
//             X[r, l - sh] where l - max(ss - 128 r, 0) >= sh; then R'
//             row steps over the row ends run[r] = X[r, 127], run[r] +=
//             run[r - sh] where r - ss[r, 127] / 128 >= sh; then X[r, l] +=
//             run[r - 1] where ss < 128 r.  Hillis-Steele: every step
//             reads the previous step's values
//   PSUM      the section's inclusive prefix sum in row-major order
//   COMPACT   perf_k2_stages.py's window compaction: tile t = r / 8 has
//             base = meta[1 + t], nsb = meta[65 + t]; with d = w - base,
//             X[r, l] = c[base / 128 + (d >> 7), d & 127] where 0 <= d >>
//             7 < 8 nsb, else 0 (c: X before the stage)
//   ADD       X += w[rows] (full), X += w[row0, 0] (touch), X += c
// All in int32 that wraps.  A C stage the TPU computed on f32 as a sum of
// seven selects maps -0.0 to +0.0; every variant quantizes what it routes
// (trunc and round of -0.0 and +0.0 are 0), so the port quantizes at LOAD
// and routes the int32 quanta: the same bits.
//
// The epilogue: the stream probes' schedule (probes/k2_kernels.py).  The
// host groups a variant's steps by out block, cuts each chain at its last
// zero into a dead part and a live part and both into pieces; a cluster
// takes a piece and runs the program on each of its sections in turn,
// every thread keeping its elements' running sums in registers; then
// stores (one live piece), adds with atomicAdd into the init-filled out
// (several), or keeps a dead piece's work by a store to a scratch word that
// only a particular sum would make.  Bits 8-9 of a piece's word name one of
// four outputs.
//
// The design.  A 512-row section is 256 KB, more than a block's 227 KB of
// shared memory, so a cluster of 4 blocks holds it, 128 rows each (64 KB,
// padded to a row pitch of 129 words against bank conflicts).  The Clos
// route's row stages (A, B, D, E) and both transposes stay inside a block:
// after T, block a holds the Y rows k*4 + a.  Only the C stage, the scans'
// row carries and the compaction read another block's shared memory, through
// the cluster (distributed shared memory), between cluster barriers.
// Bound: bytes (every stream's rows read
// once a step, each out block written once); the stages cost shared-memory
// passes, two barriers each.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 128;                         // rows a block holds
constexpr int kThreads = 1024;
constexpr int kPer = kRows * kLanes / kThreads;    // 16 elements a thread
constexpr int kRowStep = kThreads / kLanes;        // 8
constexpr int kPitch = kLanes + 1;
constexpr int kMaxRows = 512;                      // rows of a section
constexpr int kMaxOps = 24;
constexpr int kSides = 5;
constexpr int kOuts = 4;
constexpr int kMetaWords = 129;
constexpr uint32_t kSinkKey = 0x9e3779b9u;
constexpr int kSmemWords = kRows * kPitch + 2 * kRows + 2 * kMaxRows;

enum Op {
  kLoad = 0, kGather = 1, kT = 2, kTI = 3, kC = 4, kMask = 5, kScan = 6,
  kPsum = 7, kCompact = 8, kAddFull = 9, kAddTouch = 10, kAddConst = 11
};
enum Quant { kTrunc = 0, kRound = 1, kInt = 2 };
enum Kind { kDead = 0, kStore = 1, kAdd = 2 };

struct Program {
  int nops;
  int w[kMaxOps][4];  // op, then up to three arguments
};

struct Inputs {
  const void* v;
  const void* side[kSides];  // streams 1..5: u16, or u8 where u8mask says
  const int* meta;
  uint32_t* out[kOuts];
  int v_f32;
  int u8mask;
};

struct Piece {
  long long block;
  long long off;
  int count;
  int kind;
  bool zeroed;
  bool first;
  int out;
};

__device__ __forceinline__ Piece piece_at(const long long* pieces,
                                          long long p) {
  const long long* pc = pieces + 4 * p;
  const long long word = pc[3];
  return {pc[0], pc[1], (int)pc[2], (int)(word & 15), ((word >> 4) & 1) != 0,
          ((word >> 5) & 1) != 0, (int)((word >> 8) & 3)};
}

// Side stream s (1..5) at (row, col), widened.
__device__ __forceinline__ uint32_t side_at(const Inputs& in, int s,
                                            long long row, int col) {
  const int i = s - 1;
  const long long e = row * kLanes + col;
  if ((in.u8mask >> i) & 1) {
    return __ldg(static_cast<const uint8_t*>(in.side[i]) + e);
  }
  return __ldg(static_cast<const uint16_t*>(in.side[i]) + e);
}

template <int G>
__device__ __forceinline__ void cluster_sync() {
  cg::this_cluster().sync();
}

// Block `rank`'s copy of a shared-memory array of this block.
template <int G>
__device__ __forceinline__ const uint32_t* peer(uint32_t* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, (unsigned)rank);
}

struct Smem {
  uint32_t* x;     // kRows x kPitch: this block's rows of the state
  uint32_t* rend;  // kRows: this block's row ends
  uint32_t* rsr;   // kRows: their segment-start rows
  uint32_t* run;   // R: every row's end, then its row scan
  uint32_t* rsa;   // R: every row's segment-start row
};

// This thread's element e: local row and lane.
__device__ __forceinline__ int row_of(int e) {
  return (int)(threadIdx.x >> 7) + kRowStep * e;
}
__device__ __forceinline__ int lane_of() { return (int)(threadIdx.x & 127); }

// The section row of local row r in `layout` (0: V, 1: Y).
template <int G>
__device__ __forceinline__ int srow(int layout, int r, int a) {
  return layout == 0 ? a * kRows + r : r * G + a;
}

// Write the staged values y to this thread's elements, between barriers.
__device__ __forceinline__ void put(const Smem& s, const uint32_t* y) {
  __syncthreads();
  const int l = lane_of();
#pragma unroll
  for (int e = 0; e < kPer; ++e) s.x[row_of(e) * kPitch + l] = y[e];
  __syncthreads();
}

// Gather every block's row ends and segment-start rows into run/rsa, then
// `steps` masked log-shift steps over them: run[r] += run[r - sh] where
// r - rsa[r] >= sh.
template <int G>
__device__ void row_scan(const Smem& s, int steps) {
  constexpr int R = G * kRows;
  const int t = (int)threadIdx.x;
  cluster_sync<G>();
  if (t < R) {
    s.run[t] = peer<G>(s.rend, t / kRows)[t % kRows];
    s.rsa[t] = peer<G>(s.rsr, t / kRows)[t % kRows];
  }
  cluster_sync<G>();
  for (int k = 0; k < steps; ++k) {
    const int sh = 1 << k;
    uint32_t nv = 0;
    if (t < R) {
      nv = s.run[t];
      if (t - (int)s.rsa[t] >= sh) nv += s.run[t - sh];
    }
    __syncthreads();
    if (t < R) s.run[t] = nv;
    __syncthreads();
  }
}

__device__ __forceinline__ uint32_t load_one(const Inputs& in, int quant,
                                             int pad, long long row, int l) {
  const long long e = row * kLanes + l;
  if (!in.v_f32) return (uint32_t)__ldg(static_cast<const int*>(in.v) + e);
  float x = __ldcs(static_cast<const float*>(in.v) + e);
  if (pad && ((side_at(in, pad, row, l) >> 15) & 1)) x = 0.0f;
  if (quant == kTrunc) return (uint32_t)__float2int_rz(x);
  return (uint32_t)__float2int_rn(__fmul_rn(x, 1073741824.0f));
}

// Run `prog` on the section whose rows start at row0; returns the layout
// the state ends in.
template <int G>
__device__ int run_program(const Inputs& in, const Program& prog,
                           long long row0, int a, const Smem& s) {
  constexpr int R = G * kRows;
  const int l = lane_of();
  int layout = 0;
  uint32_t y[kPer];
  for (int p = 0; p < prog.nops; ++p) {
    const int op = prog.w[p][0], a1 = prog.w[p][1], a2 = prog.w[p][2],
              a3 = prog.w[p][3];
    switch (op) {
      case kLoad: {
        layout = a3;
        __syncthreads();
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int r = row_of(e);
          s.x[r * kPitch + l] =
              load_one(in, a1, a2, row0 + srow<G>(layout, r, a), l);
        }
        __syncthreads();
        break;
      }
      case kGather: {
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int r = row_of(e);
          const int idx =
              a1 ? (int)((side_at(in, a1, row0 + srow<G>(layout, r, a), l) >>
                          a2) & 127)
                 : ((l + a2) & 127);
          y[e] = s.x[r * kPitch + idx];
        }
        put(s, y);
        break;
      }
      case kT:
      case kTI: {
#pragma unroll
        for (int e = 0; e < kPer; ++e) y[e] = s.x[l * kPitch + row_of(e)];
        put(s, y);
        layout = op == kT ? 1 : 0;
        break;
      }
      case kC: {
        cluster_sync<G>();
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int r = row_of(e);
          const int i = r * G + a;
          const int g = (int)((side_at(in, a1, row0 + i, l) >> 7) & 3);
          const int src = (i & ~3) | g;
          y[e] = peer<G>(s.x, src % G)[(src / G) * kPitch + l];
        }
        cluster_sync<G>();
        put(s, y);
        break;
      }
      case kMask: {
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int r = row_of(e);
          if (!((side_at(in, a1, row0 + srow<G>(layout, r, a), l) >> 15) &
                1)) {
            s.x[r * kPitch + l] = 0u;
          }
        }
        __syncthreads();
        break;
      }
      case kScan: {
        int lane_d[kPer], ls[kPer];
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int sr = a * kRows + row_of(e);
          ls[e] = (int)side_at(in, a1, row0 + sr, l) - sr * kLanes;
          lane_d[e] = l - max(ls[e], 0);
        }
        for (int k = 0; k < a2; ++k) {
          const int sh = 1 << k;
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            const int r = row_of(e);
            y[e] = s.x[r * kPitch + l];
            if (lane_d[e] >= sh) y[e] += s.x[r * kPitch + l - sh];
          }
          put(s, y);
        }
        if (a3 > 0) {
          const int t = (int)threadIdx.x;
          if (t < kRows) {
            s.rend[t] = s.x[t * kPitch + kLanes - 1];
            s.rsr[t] =
                side_at(in, a1, row0 + a * kRows + t, kLanes - 1) / kLanes;
          }
          row_scan<G>(s, a3);
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            if (ls[e] < 0) {
              const int r = row_of(e);
              s.x[r * kPitch + l] += s.run[a * kRows + r - 1];
            }
          }
          __syncthreads();
        }
        break;
      }
      case kPsum: {
        for (int k = 0; k < 7; ++k) {
          const int sh = 1 << k;
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            const int r = row_of(e);
            y[e] = s.x[r * kPitch + l];
            if (l >= sh) y[e] += s.x[r * kPitch + l - sh];
          }
          put(s, y);
        }
        const int t = (int)threadIdx.x;
        if (t < kRows) {
          s.rend[t] = s.x[t * kPitch + kLanes - 1];
          s.rsr[t] = 0u;
        }
        row_scan<G>(s, 9);
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int r = row_of(e);
          s.x[r * kPitch + l] += s.run[a * kRows + r] - s.rend[r];
        }
        __syncthreads();
        break;
      }
      case kCompact: {
        const int* m = in.meta + (row0 / R) * kMetaWords;
        cluster_sync<G>();
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int sr = a * kRows + row_of(e);
          const int base = __ldg(m + 1 + (sr >> 3));
          const int nsb = __ldg(m + 65 + (sr >> 3));
          const int d = (int)side_at(in, a1, row0 + sr, l) - base;
          const int hi = d >> 7;
          y[e] = 0u;
          if (hi >= 0 && hi < 8 * nsb) {
            const int cr = (base >> 7) + hi;
            y[e] = peer<G>(s.x, cr / kRows)[(cr % kRows) * kPitch + (d & 127)];
          }
        }
        cluster_sync<G>();
        put(s, y);
        break;
      }
      case kAddFull:
      case kAddTouch:
      case kAddConst: {
        const uint32_t c = op == kAddConst   ? (uint32_t)a1
                           : op == kAddTouch ? side_at(in, a1, row0, 0)
                                             : 0u;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int r = row_of(e);
          s.x[r * kPitch + l] +=
              op == kAddFull
                  ? side_at(in, a1, row0 + srow<G>(layout, r, a), l)
                  : c;
        }
        __syncthreads();
        break;
      }
    }
  }
  return layout;
}

template <int G>
__global__ void __launch_bounds__(kThreads, 1)
    sec_route_kernel(Inputs in, Program prog,
                     const long long* __restrict__ pieces,
                     const long long* __restrict__ chain,
                     uint32_t* __restrict__ sink, uint32_t init) {
  extern __shared__ uint32_t smem[];
  const Smem s{smem, smem + kRows * kPitch, smem + kRows * kPitch + kRows,
               smem + kRows * kPitch + 2 * kRows,
               smem + kRows * kPitch + 2 * kRows + kMaxRows};
  const int a = (int)cg::this_cluster().block_rank();
  const Piece pc = piece_at(pieces, blockIdx.x / G);
  uint32_t start = 0;
  if (pc.kind == kStore) start = pc.zeroed ? 0u : init;
  if (pc.kind == kAdd && pc.first && pc.zeroed) start = 0u - init;
  uint32_t acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) acc[e] = start;
  const int l = lane_of();
  int layout = 0;
  for (int k = 0; k < pc.count; ++k) {
    layout = run_program<G>(in, prog, __ldg(chain + pc.off + k), a, s);
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[e] += s.x[row_of(e) * kPitch + l];
    __syncthreads();
  }
  uint32_t* o = in.out[pc.out] + pc.block * (long long)(G * kRows) * kLanes;
  uint32_t fold = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const long long at = (long long)srow<G>(layout, row_of(e), a) * kLanes + l;
    if (pc.kind == kStore) {
      o[at] = acc[e];
    } else if (pc.kind == kAdd) {
      atomicAdd(o + at, acc[e]);
    }
    fold ^= acc[e];
  }
  if (pc.kind == kDead && fold == kSinkKey) *sink = fold;
  cluster_sync<G>();  // no block leaves while a peer may read its memory
}

template <int G>
int launch(const Inputs& in, const Program& prog, const long long* pieces,
           const long long* chain, uint32_t* sink, long long npieces,
           uint32_t init, cudaStream_t stream) {
  if (npieces <= 0) return 0;
  const long long grid = npieces * G;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  constexpr size_t smem = sizeof(uint32_t) * kSmemWords;
  auto kernel = sec_route_kernel<G>;
  static bool attr_set = false;  // once, before any graph capture
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, in, prog, pieces, chain, sink, init);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int G>
int entry(const void* v, const void* s1, const void* s2, const void* s3,
          const void* s4, const void* s5, const void* meta, void* out0,
          void* out1, void* out2, void* out3, const void* pieces,
          const void* chain, void* sink, const int* program,
          long long npieces, int nops, int v_f32, int u8mask, int init,
          void* stream) {
  if (nops < 1 || nops > kMaxOps) return (int)cudaErrorInvalidValue;
  Program prog{};
  prog.nops = nops;
  for (int p = 0; p < nops; ++p)
    for (int k = 0; k < 4; ++k) prog.w[p][k] = program[4 * p + k];
  const Inputs in{v,
                  {s1, s2, s3, s4, s5},
                  static_cast<const int*>(meta),
                  {static_cast<uint32_t*>(out0), static_cast<uint32_t*>(out1),
                   static_cast<uint32_t*>(out2), static_cast<uint32_t*>(out3)},
                  v_f32,
                  u8mask};
  return launch<G>(in, prog, static_cast<const long long*>(pieces),
                   static_cast<const long long*>(chain),
                   static_cast<uint32_t*>(sink), npieces, (uint32_t)init,
                   (cudaStream_t)stream);
}

}  // namespace

// The entry point launches on `stream` and returns the CUDA error (0 on
// success; nothing is launched for npieces == 0).  Device pointers: v
// (rows, 128) f32 (v_f32 != 0) or int32; s1..s5 (rows, 128) u16, or u8
// where bit s-1 of u8mask is set (null where the program names none);
// meta (sections, 129) int32 or null; out0..out3 (nout * R, 128) int32,
// filled with init by the caller (null past the outputs used); pieces
// (npieces, 4) int64 [block, chain offset, steps, kind | zeroed << 4 |
// first << 5 | output << 8]; chain the row0 of every piece's steps; sink
// one scratch word.  program is a HOST pointer to nops x 4 int32 (op and
// arguments, the header's list), checked by the caller.
extern "C" int probe_sec_route(const void* v, const void* s1, const void* s2,
                               const void* s3, const void* s4, const void* s5,
                               const void* meta, void* out0, void* out1,
                               void* out2, void* out3, const void* pieces,
                               const void* chain, void* sink,
                               const int* program, long long npieces,
                               int nops, int v_f32, int u8mask, int init,
                               void* stream) {
  return entry<4>(v, s1, s2, s3, s4, s5, meta, out0, out1, out2, out3, pieces,
                  chain, sink, program, npieces, nops, v_f32, u8mask, init,
                  stream);
}
