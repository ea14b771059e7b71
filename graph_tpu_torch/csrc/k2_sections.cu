// K2 stage probes: the TPU's K2 section program (route 1, segmented scan,
// route 2) and its stage-by-stage variants, run on Hopper.  Counterparts
// of the seven Pallas sites of the K2 stage-attribution and transpose
// micro-benchmarks, as two instances of one kernel:
//
//   probe_sec_route  sections of 512 rows x 128 lanes, a cluster of 8
//                    blocks each; replaces scripts/perf_k2_stages.py:66
//                    (bench: k_io, k_route, k_mxucsum, k_segscan,
//                    k_compact), perf_k2v2_stages.py:86 (variant_kernel),
//                    perf_k2_route_ops.py:113 (variant_kernel) and :167
//                    (the inline C stage), and perf_transpose.py:33 (mk:
//                    copy, t512x2, taa512)
//   probe_sec128     sections of 128 rows, a cluster of 2 blocks each;
//                    replaces scripts/perf_k2_sec128.py:159 (k2_128) and
//                    :218 (k2_quad, four outputs), and perf_transpose.py:33's
//                    t128x8 and taa128x4
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
// All in int32 that wraps.  The C stage and the compaction are stages of
// 512-row sections only (the host refuses them at 128 rows).  A C stage the
// TPU computed on f32 as a sum of seven selects maps -0.0 to +0.0; every
// variant quantizes what it routes (trunc and round of -0.0 and +0.0 are
// 0), so the port quantizes at LOAD and routes the int32 quanta: the same
// bits.
//
// The epilogue: the stream probes' schedule (probes/k2_kernels.py).  The
// host groups a variant's steps by out block, cuts each chain at its last
// zero into a dead part and a live part and both into pieces; a cluster
// takes a piece and runs the program on each of its sections in turn,
// every thread keeping its elements' running sums in registers; then
// stores (one live piece, 16 bytes a store), adds with atomicAdd into the
// init-filled out (several), or keeps a dead piece's work by a store to a
// scratch word that only a particular sum would make.  Bits 8-9 of a
// piece's word name one of four outputs.
//
// Bound: bytes.  Every step's rows of v and of each side the program reads
// in full, one word of each touched side, each out block written once
// (k2_stage_kernels.moved_bytes); the int32 adds are far below the card's
// rate.  At perf_k2_sec128.py's 32 sections that is 2.3 MB, 0.0025 ms at
// 3.35 TB/s: less than a launch costs, so such a call is held back by the
// launch and by each section's chain of dependent stages, not by bytes.
//
// The design.  A section is split over the B blocks of a cluster, 64 rows a
// block, 512 threads a block (B = 2 at 128 rows, 8 at 512: a cluster of 4
// would need 128 rows a block, whose buffers and slots do not fit in 227
// KB):
// - Warp w owns 4 state rows, lane t of it lanes 4t .. 4t+3 of each: the
//   state and its running sums are registers.  State row i is section row
//   i in the V layout and Y row i in the Y layout, and a side word is read
//   at the state's own row, so every side word a thread reads lies at one
//   of its own elements, in both layouts, except: the scan's start word at
//   lane 127 of each row (lane 31's own, which publishes it with the row's
//   end); add_touch's word at (row0, 0) and the compaction's two meta words
//   a warp, which every thread reads from device memory itself.  So no
//   stage needs another thread's side words.
// - Row-local stages take no block barrier: masks and adds in registers,
//   the scans' and prefix sums' lane steps by warp shuffles, the gathers
//   through the warp's own rows of a shared buffer between two
//   __syncwarp().  The C stage takes no barrier at all: a warp's four rows
//   are a four-row group of the Y layout, so its source row is one of the
//   thread's own four registers at the same lane.  The scans run the masked
//   steps: their closed form holds only where the start words are true
//   segment starts.
// - Stages that cross rows take one cluster barrier each.  T: each thread
//   stores its rows' values at each of its lanes, 16 B, straight into the
//   block that holds the Y row (remote or not; element (a*128 + j, k) goes
//   to (4k + a, j) at 512 rows), then reads its own rows back.  TI at 128
//   rows is T; at 512 it pulls: each thread stores its own rows into its
//   block's buffer and, after the barrier, loads its V rows' four lanes
//   16 B at a time from the Y rows that hold them, the mirror of T's
//   stores (a push would take sixteen 4-byte stores a thread: 1.3 times
//   slower on the card).  At 512 rows the buffer layout (lay) puts the
//   16-byte pieces that four lanes of a warp store into (or load from) one
//   block side by side, 64 B, since the cost of distributed shared memory
//   follows the number of its transactions.  The row carries of scan and
//   psum: lane 31 of each warp hands its rows' ends (and start rows) to the
//   warp's lanes, which store them into every block of the cluster (8 B
//   each); after the barrier warp 0 of each block computes every row's
//   carry from all R ends, R/32 a lane, and writes it over the array, and
//   the block syncs (__syncthreads) before each warp reads its rows'.  The
//   compaction stores the state into the buffer and, after the barrier,
//   loads each element's source word from whichever block holds it.
// - Two buffers (and two row-end arrays) alternate between crossings: a
//   crossing stores into buffer b, the cluster syncs once, threads read
//   (their own rows, or a peer's by a pull), and b flips.  That is safe
//   for pushes and pulls alike: a crossing's reads of buffer b, its own or
//   a peer's, end before the reader arrives at the next crossing's
//   barrier, and the next stores into buffer b come a crossing after that,
//   behind that barrier (warp 0's carries overwrite its own block's array
//   between the two, read by its block only, behind the block barrier).  A
//   gather's scratch rows must not be a buffer a peer may still pull from:
//   at 128 rows nothing is pulled from the state buffers, and a gather uses
//   the last crossing's buffer (into whose rows of this warp nobody stores
//   until the crossing after next); at 512 rows TI and the compaction pull
//   until the next barrier, so gathers use a third buffer, whose rows only
//   their warp ever touches.  The crossings' barriers release and acquire
//   (cluster_barrier).  The cluster also meets once at the start, so that
//   no block stores into a peer that has not begun, and once at the end, so
//   that none leaves while its peers may still read it; those two order no
//   memory (cluster_meet): the peers' last reads of a block returned before
//   they stored the sums that used them, and pushes into it were waited
//   for at its own last crossing.
// - Each side has a slot of shared memory, filled by cp.async once a
//   section and waited for (wait_group, no barrier) before its first use;
//   v too, from a piece's second section on (its first is read from device
//   memory, which is faster for a piece of one section).  A longer piece
//   fetches the next section's v right after the load and each side right
//   after its last use here.  A slot is one side's for the whole launch,
//   so it keeps one width, and a thread's words of it are its own: it alone
//   fetches them and reads them, and no peer touches the slots.  So a
//   refill takes no barrier: it follows the thread's own last read of the
//   slot in program order (the asm's memory clobber keeps the compiler from
//   moving the read past it), and the slot's fetch for this section was
//   waited for before that read, so no two copies into one word are ever in
//   flight (cp.async orders none between them).
// - 512 threads leave 128 registers a thread; the 512-row instance needs
//   all of them, so the piece is read again for the epilogue and the
//   slots' tickets are bytes.  Shared memory a block: the state buffers
//   (two, three at 512 rows, 32 KB each), the row ends (two arrays of R x
//   8 B), five 16 KB side slots and a 32 KB v slot: 182,272 B at 128
//   rows, 221,184 B at 512.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRW = 4;  // rows a warp
constexpr int kRB = kWarps * kRW;  // rows a block
constexpr int kBuf = kRB * kLanes;
constexpr int kMaxOps = 24;
constexpr int kSides = 5;
constexpr int kOuts = 4;
constexpr int kMetaWords = 129;
constexpr int kSlotWords = kThreads * kRW * 2;  // 4 u16 a row a thread
constexpr int kVWords = kThreads * kRW * 4;     // 4 words a row a thread
constexpr uint32_t kSinkKey = 0x9e3779b9u;

// A section of R rows over a cluster of B blocks: row groups G (Y row k*G
// + a), row ends a thread scans, state buffers, shared-memory words.
template <int R>
struct Shape {
  static constexpr int B = R / kRB;
  static constexpr int G = R / kLanes;
  static constexpr int kEnds = R / 32;
  static constexpr int kBufs = R == 512 ? 3 : 2;
  static constexpr int kSmemWords =
      kBufs * kBuf + 4 * R + kSides * kSlotWords + kVWords;
  static_assert(R == 128 || R == 512, "sections of 128 or 512 rows");
};

enum Op {
  kLoad = 0, kGather = 1, kT = 2, kTI = 3, kC = 4, kMask = 5, kScan = 6,
  kPsum = 7, kCompact = 8, kAddFull = 9, kAddTouch = 10, kAddConst = 11
};
enum Quant { kTrunc = 0, kRound = 1, kInt = 2 };
enum Kind { kDead = 0, kStore = 1, kAdd = 2 };

// The program's words, the slot each stage's side lies in (-1: none), and
// the fetches of the next section's sides: after stage ev_after, side
// ev_side into slot ev_slot.
struct Program {
  int nops;
  int w[kMaxOps][4];
  int slot[kMaxOps];
  int nev;
  int ev_after[kSides];
  int ev_side[kSides];
  int ev_slot[kSides];
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

// (volatile, so that a piece read again is not kept in registers between)
__device__ __forceinline__ Piece piece_at(const volatile long long* pieces,
                                          long long p) {
  const volatile long long* pc = pieces + 4 * p;
  const long long word = pc[3];
  return {pc[0], pc[1], (int)pc[2], (int)(word & 15), ((word >> 4) & 1) != 0,
          ((word >> 5) & 1) != 0, (int)((word >> 8) & 3)};
}

// Word of element (r, c) of a block's state buffer (r its local row, c a
// lane), in 16-byte groups of four lanes.  At 128 rows the groups are
// XOR-swizzled by row, so that a warp's 16-byte stores along a row and its
// loads down a column of four-row groups meet few bank conflicts (none at
// 16 bytes).  At 512 rows the four rows r, r + 16, r + 32, r + 48 of a
// group lie side by side (their order XOR-swizzled by the group), so that
// the four lanes of a warp whose transpose stores (or TI loads) go to one
// block touch 64 contiguous bytes there, and a warp's loads along a row
// meet no bank conflict.
template <int R>
__device__ __forceinline__ int lay(int r, int c) {
  if (R == 128)
    return r * kLanes + ((((c >> 2) ^ (r >> 2)) & 7) << 2) +
           ((c >> 2) & ~7) * 4 + (c & 3);
  return ((((r & 15) * 32 + (c >> 2)) * 4 + ((r >> 4) ^ ((c >> 3) & 3)))
          << 2) + (c & 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int Bytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(Bytes)
               : "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most n of this thread's cp.async groups are in flight.
// At the first use in a section of v or a side at most the other sides'
// fetches and v's (for the section after) were committed after its own
// (plan_slots orders them), so n <= 5.
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 1: wait_group<1>(); break;
    case 2: wait_group<2>(); break;
    case 3: wait_group<3>(); break;
    case 4: wait_group<4>(); break;
    case 5: wait_group<5>(); break;
    default: wait_group<0>(); break;
  }
}

// Side stream s (1..5) and output o: selects, so that nothing is copied to
// the stack to be indexed.
__device__ __forceinline__ const void* side_ptr(const Inputs& in, int s) {
  return s == 1 ? in.side[0] : s == 2 ? in.side[1] : s == 3 ? in.side[2]
       : s == 4 ? in.side[3] : in.side[4];
}
__device__ __forceinline__ uint32_t* out_ptr(const Inputs& in, int o) {
  return o == 0 ? in.out[0] : o == 1 ? in.out[1] : o == 2 ? in.out[2]
                                                          : in.out[3];
}

__device__ __forceinline__ int warp_id() { return (int)(threadIdx.x >> 5); }
__device__ __forceinline__ int lane_id() { return (int)(threadIdx.x & 31); }

// One barrier of the cluster's threads: each thread's shared-memory
// stores and loads before it, its own block's or a peer's, are ordered
// before every access after it (release and acquire).
__device__ __forceinline__ void cluster_barrier() {
  cg::this_cluster().sync();
}

// A barrier of the cluster's threads that orders no memory: only that
// every thread has come this far.
__device__ __forceinline__ void cluster_meet() {
  asm volatile(
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Block `rank`'s copy of a shared-memory array of this block.
__device__ __forceinline__ uint32_t* peer(uint32_t* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, (unsigned)rank);
}

// Fetch this thread's words of side s (its kRW rows from section row r0)
// into a slot and commit them as one cp.async group.
__device__ __forceinline__ void fetch(const Inputs& in, uint32_t* slot,
                                      int s, long long r0) {
  const int tid = (int)threadIdx.x;
  const long long e0 = r0 * kLanes + 4 * lane_id();
  if ((in.u8mask >> (s - 1)) & 1) {
    const uint8_t* p = static_cast<const uint8_t*>(side_ptr(in, s)) + e0;
#pragma unroll
    for (int k = 0; k < kRW; ++k)
      cp_async<4>(smem_addr(slot + k * kThreads + tid), p + k * kLanes);
  } else {
    const uint16_t* p = static_cast<const uint16_t*>(side_ptr(in, s)) + e0;
#pragma unroll
    for (int k = 0; k < kRW; ++k)
      cp_async<8>(smem_addr(slot + 2 * (k * kThreads + tid)), p + k * kLanes);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Fetch this thread's words of v (its kRW rows from section row r0, 16 B a
// row, through L2 only) into the v slot and commit them as one group.
__device__ __forceinline__ void fetch_v(const Inputs& in, uint32_t* vslot,
                                        long long r0) {
  const int tid = (int)threadIdx.x;
  const uint32_t* p =
      static_cast<const uint32_t*>(in.v) + r0 * kLanes + 4 * lane_id();
#pragma unroll
  for (int k = 0; k < kRW; ++k)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(vslot + 4 * (k * kThreads + tid))),
                 "l"(p + k * kLanes)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Side s at this thread's four elements of its row k, widened, from the
// slot `fetch` filled.
__device__ __forceinline__ void side4(const Inputs& in, const uint32_t* slot,
                                      int s, int k, uint32_t out[4]) {
  const int i = k * kThreads + (int)threadIdx.x;
  if ((in.u8mask >> (s - 1)) & 1) {
    const uint32_t b = slot[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = (b >> (8 * j)) & 255u;
  } else {
    const uint2 h = reinterpret_cast<const uint2*>(slot)[i];
    out[0] = h.x & 0xffffu;
    out[1] = h.x >> 16;
    out[2] = h.y & 0xffffu;
    out[3] = h.y >> 16;
  }
}

// The lanes a gather by side s (0: none) shifted by sh reads at this
// thread's four elements of its row k.
__device__ __forceinline__ void gather_idx(const Inputs& in,
                                           const uint32_t* slot, int s,
                                           int sh, int k, uint32_t idx[4]) {
  if (s) {
    side4(in, slot, s, k, idx);
#pragma unroll
    for (int j = 0; j < 4; ++j) idx[j] = (idx[j] >> sh) & 127u;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      idx[j] = (uint32_t)(4 * lane_id() + j + sh) & 127u;
  }
}

__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}

// A (32 N)-vector a warp holds, q[j] at position N t + j: `steps` masked
// Hillis-Steele steps sh = 1, 2, 4, ..: q[p] += q[p - sh] where d[p] >= sh
// (`adds(j, sh)`: for this lane's q[j]), every step reading the previous
// step's values.  d[p] <= p, so no step reads below position 0.
template <int N, typename Adds>
__device__ __forceinline__ void masked_steps(uint32_t q[N], Adds adds,
                                             int steps) {
#pragma unroll
  for (int s = 0; s < log2i(32 * N); ++s) {
    if (s < steps) {
      const int sh = 1 << s;
      uint32_t p[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        // position N t + j - sh: element (j - sh) mod N of this lane or,
        // below j = sh, of a lane up (N is a power of two)
        if (sh >= N) {
          p[j] = __shfl_up_sync(~0u, q[j], sh / N);
        } else if (j >= sh) {
          p[j] = q[(j - sh) & (N - 1)];
        } else {
          p[j] = __shfl_up_sync(~0u, q[(j - sh) & (N - 1)], 1);
        }
      }
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (adds(j, sh)) q[j] += p[j];
    }
  }
}

// The inclusive sums of a (32 N)-vector a warp holds as in masked_steps,
// with each position's exclusive sum in ex (wrapping int32).
template <int N>
__device__ __forceinline__ void warp_prefix(uint32_t q[N], uint32_t ex[N]) {
  const int t = lane_id();
  uint32_t total = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    ex[j] = total;
    total += q[j];
  }
  uint32_t inc = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(~0u, inc, o);
    if (t >= o) inc += y;
  }
  const uint32_t before = inc - total;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    ex[j] += before;
    q[j] += ex[j];
  }
}

// The word of row r's (end, start row) pair in a row-end array: row N t +
// e is read by lane t, and pairs (e, e + 1) of the 32 lanes lie side by
// side, so that a warp's 16-byte loads of them meet no bank conflict.
template <int R>
__device__ __forceinline__ int end_word(int r) {
  constexpr int N = Shape<R>::kEnds;
  return 4 * ((r % N) / 2 * 32 + r / N) + 2 * (r & 1);
}

// Row `row`'s end and segment-start row, at lane 31 of the warp that holds
// it, into row-end array `ends` of every block of the cluster: lane c of
// the warp stores them (8 B) into block c.
template <int R>
__device__ __forceinline__ void publish_end(uint32_t* ends, int row,
                                            uint32_t end, uint32_t start) {
  const int t = lane_id();
  end = __shfl_sync(~0u, end, 31);
  start = __shfl_sync(~0u, start, 31);
  if (t < Shape<R>::B)
    *reinterpret_cast<uint2*>(peer(ends, t) + end_word<R>(row)) =
        make_uint2(end, start);
}

// The crossing of the row carries, once every row's end is published: the
// cluster syncs; warp 0 reads every row's (end, start row), R / 32 rows a
// lane (rows N t ..), and writes each row's carry over the array, at word
// (r % N) * 32 + r / N for row r: with `steps` > 0 the scan's, run[r - 1]
// after that many masked row steps (row 0's is never added), else the
// prefix sum's, the sum of the ends of the rows before r; the block syncs;
// each thread reads the carries of its rows into c.
template <int R>
__device__ __forceinline__ void row_carries(uint32_t* ends, int steps,
                                            int srow_base, uint32_t c[kRW]) {
  constexpr int N = Shape<R>::kEnds;
  const int t = lane_id();
  cluster_barrier();
  if (warp_id() == 0) {
    uint32_t run[N], st[N];
#pragma unroll
    for (int e2 = 0; e2 < N / 2; ++e2) {
      const uint4 q =
          *reinterpret_cast<const uint4*>(ends + 4 * (e2 * 32 + t));
      run[2 * e2] = q.x;
      st[2 * e2] = q.y;
      run[2 * e2 + 1] = q.z;
      st[2 * e2 + 1] = q.w;
    }
    __syncwarp();
    int shift = 0;  // carries of row r at position r + shift
    if (steps > 0) {
      // d >= sh for the steps sh below 2^len, len the bit length of d (0
      // where d <= 0): 4 bits a row, 8 rows a word
      uint32_t len[(N + 7) / 8];
#pragma unroll
      for (int i = 0; i < (N + 7) / 8; ++i) len[i] = 0;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int d = N * t + e - (int)st[e];
        len[e / 8] |= (uint32_t)(d > 0 ? 32 - __clz(d) : 0) << (4 * (e % 8));
      }
      masked_steps<N>(
          run,
          [&](int j, int sh) {
            return (int)((len[j / 8] >> (4 * (j % 8))) & 15u) > __ffs(sh) - 1;
          },
          steps);
      shift = 1;
    } else {
      uint32_t before[N];
      warp_prefix<N>(run, before);
#pragma unroll
      for (int e = 0; e < N; ++e) run[e] = before[e];
    }
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int r = N * t + e + shift;
      if (r < R) ends[(r % N) * 32 + r / N] = run[e];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRW; ++k) {
    const int r = srow_base + k;
    c[k] = ends[(r % N) * 32 + r / N];
  }
}

// Tickets: the number (mod 256) of each slot's latest cp.async group, a
// byte a slot, slots 0-3 in tk[0] and slot 4 and v (slot kSides) in tk[1]
// (selects, so that tk stays in registers).
__device__ __forceinline__ int ticket(int slot, const uint32_t tk[2]) {
  return (int)(((slot < 4 ? tk[0] : tk[1]) >> (8 * (slot & 3))) & 255u);
}
__device__ __forceinline__ void set_ticket(int slot, uint32_t tk[2],
                                           int n) {
  const int sh = 8 * (slot & 3);
  uint32_t& word = slot < 4 ? tk[0] : tk[1];
  word = (word & ~(255u << sh)) | ((uint32_t)n << sh);
}

// Wait until slot `slot`'s latest group has landed: at most the groups
// committed after it (mod 256) may still be in flight.
__device__ __forceinline__ void wait_slot(int slot, const uint32_t tk[2],
                                          int committed) {
  wait_pending((committed - 1 - ticket(slot, tk)) & 255);
}

// Fetch side s into a slot as the next group, and note its number.
__device__ __forceinline__ void start_fetch(const Inputs& in,
                                            uint32_t* slots, int s, int slot,
                                            long long r0, int& committed,
                                            uint32_t tk[2]) {
  fetch(in, slots + slot * kSlotWords, s, r0);
  set_ticket(slot, tk, committed);
  committed = (committed + 1) & 255;
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    sections_kernel(Inputs in, Program prog,
                    const long long* __restrict__ pieces,
                    const long long* __restrict__ chain,
                    uint32_t* __restrict__ sink, uint32_t init) {
  using S = Shape<R>;
  constexpr int B = S::B, G = S::G;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* const bufs = smem;                     // kBufs x kBuf
  uint32_t* const ends = smem + S::kBufs * kBuf;   // 2 x R x (end, start)
  uint32_t* const slots = ends + 4 * R;            // kSides x kSlotWords
  uint32_t* const vslot = slots + kSides * kSlotWords;  // kVWords
  const int w = warp_id(), t = lane_id();
  const int a = (int)cg::this_cluster().block_rank();
  const int row_base = kRW * w;              // this warp's first local row
  const int srow_base = a * kRB + row_base;  // .. as a row of the section
  // T's and TI's Y rows (4t + j) G + ga hold lanes gl .. gl+3 of this
  // thread's V rows
  const int ga = G == 1 ? 0 : srow_base / kLanes;
  const int gl = G == 1 ? srow_base : srow_base % kLanes;
  const Piece pc = piece_at(pieces, blockIdx.x / B);
  uint32_t start = 0;
  if (pc.kind == kStore) start = pc.zeroed ? 0u : init;
  if (pc.kind == kAdd && pc.first && pc.zeroed) start = 0u - init;
  const long long off = pc.off;  // the rest of the piece is read again last
  const int count = pc.count;
  uint32_t acc[kRW][4], x[kRW][4];
#pragma unroll
  for (int k = 0; k < kRW; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = start, x[k][j] = 0u;

  int b = 0;       // the buffer of the next crossing stage
  int committed = 0;  // cp.async groups committed (mod 256)
  uint32_t tk[2] = {0, 0};
  // the first section's sides (its v is read from device memory; a longer
  // piece fetches the next section's during this one)
  if (count > 0) {
    const long long row0 = __ldg(chain + off);
    for (int e = 0; e < prog.nev; ++e)
      start_fetch(in, slots, prog.ev_side[e], prog.ev_slot[e],
                  row0 + srow_base, committed, tk);
  }
  cluster_meet();  // the peers have begun: they may be stored into

  for (int sec = 0; sec < count; ++sec) {
    const long long row0 = __ldg(chain + off + sec);
    const long long next =
        sec + 1 < count ? __ldg(chain + off + sec + 1) : -1;
    int ev = 0;
    for (int p = 0; p < prog.nops; ++p) {
      const int op = prog.w[p][0], a1 = prog.w[p][1], a2 = prog.w[p][2],
                a3 = prog.w[p][3];
      const int sl = prog.slot[p];
      const uint32_t* slot = nullptr;
      if (sl >= 0) {
        wait_slot(sl, tk, committed);
        slot = slots + sl * kSlotWords;
      }
      // the next crossing's buffer and row ends; a gather's scratch
      uint32_t* const buf = bufs + b * kBuf;
      uint32_t* const bends = ends + b * 2 * R;
      uint32_t* const scratch =
          S::kBufs == 3 ? bufs + 2 * kBuf : bufs + (b ^ 1) * kBuf;
      switch (op) {
        case kLoad: {
          // a piece's first section from device memory, the others from
          // the v slot
          if (sec > 0) wait_slot(kSides, tk, committed);
#pragma unroll
          for (int k = 0; k < kRW; ++k) {
            const uint4 q =
                sec == 0
                    ? __ldcs(reinterpret_cast<const uint4*>(
                          static_cast<const uint32_t*>(in.v) +
                          (row0 + srow_base + k) * kLanes + 4 * t))
                    : reinterpret_cast<const uint4*>(
                          vslot)[k * kThreads + (int)threadIdx.x];
            if (!in.v_f32) {
              x[k][0] = q.x;
              x[k][1] = q.y;
              x[k][2] = q.z;
              x[k][3] = q.w;
              continue;
            }
            float f[4] = {__uint_as_float(q.x), __uint_as_float(q.y),
                          __uint_as_float(q.z), __uint_as_float(q.w)};
            if (a2) {
              uint32_t pad[4];
              side4(in, slot, a2, k, pad);
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if ((pad[j] >> 15) & 1) f[j] = 0.0f;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
              x[k][j] = a1 == kTrunc ? (uint32_t)__float2int_rz(f[j])
                                     : (uint32_t)__float2int_rn(
                                           __fmul_rn(f[j], 1073741824.0f));
          }
          break;
        }
        case kGather: {
          // through this warp's rows of the scratch buffer (row-major:
          // no other stage reads them)
          uint32_t* const rows = scratch + row_base * kLanes;
#pragma unroll
          for (int k = 0; k < kRW; ++k)
            *reinterpret_cast<uint4*>(rows + k * kLanes + 4 * t) =
                make_uint4(x[k][0], x[k][1], x[k][2], x[k][3]);
          __syncwarp();
#pragma unroll
          for (int k = 0; k < kRW; ++k) {
            uint32_t idx[4];
            gather_idx(in, slot, a1, a2, k, idx);
#pragma unroll
            for (int j = 0; j < 4; ++j) x[k][j] = rows[k * kLanes + idx[j]];
          }
          __syncwarp();
          break;
        }
        case kT:
        case kTI: {
          if (R == 128 || op == kT) {
            // push: element (ga*128 + gl + k, 4t + j) of this thread goes
            // to Y row (4t + j) G + ga, lane gl + k, in the block that
            // holds it (remote stores need no reply); a 128-row section's
            // TI is this same plain transpose
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int yr = (4 * t + j) * G + ga;
              *reinterpret_cast<uint4*>(peer(buf, yr / kRB) +
                                        lay<R>(yr % kRB, gl)) =
                  make_uint4(x[0][j], x[1][j], x[2][j], x[3][j]);
            }
            cluster_barrier();
#pragma unroll
            for (int k = 0; k < kRW; ++k) {
              const uint4 c = *reinterpret_cast<const uint4*>(
                  buf + lay<R>(row_base + k, 4 * t));
              x[k][0] = c.x;
              x[k][1] = c.y;
              x[k][2] = c.z;
              x[k][3] = c.w;
            }
          } else {
            // pull (TI at 512 rows): the mirror of T's stores
#pragma unroll
            for (int k = 0; k < kRW; ++k)
              *reinterpret_cast<uint4*>(buf + lay<R>(row_base + k, 4 * t)) =
                  make_uint4(x[k][0], x[k][1], x[k][2], x[k][3]);
            cluster_barrier();
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int yr = (4 * t + j) * G + ga;
              const uint4 c = *reinterpret_cast<const uint4*>(
                  peer(buf, yr / kRB) + lay<R>(yr % kRB, gl));
              x[0][j] = c.x;
              x[1][j] = c.y;
              x[2][j] = c.z;
              x[3][j] = c.w;
            }
          }
          b ^= 1;
          break;
        }
        case kC: {
          if constexpr (R == 512) {
            // this warp's rows are the four-row group (i & ~3): the
            // source is the thread's own register row g, same lane
            uint32_t y[kRW][4];
#pragma unroll
            for (int k = 0; k < kRW; ++k) {
              uint32_t g[4];
              side4(in, slot, a1, k, g);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const bool odd = (g[j] >> 7) & 1, high = (g[j] >> 8) & 1;
                y[k][j] = high ? (odd ? x[3][j] : x[2][j])
                               : (odd ? x[1][j] : x[0][j]);
              }
            }
#pragma unroll
            for (int k = 0; k < kRW; ++k)
#pragma unroll
              for (int j = 0; j < 4; ++j) x[k][j] = y[k][j];
          }
          break;
        }
        case kMask:
        case kAddFull: {
#pragma unroll
          for (int k = 0; k < kRW; ++k) {
            uint32_t sv[4];
            side4(in, slot, a1, k, sv);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (op == kAddFull) {
                x[k][j] += sv[j];
              } else if (!((sv[j] >> 15) & 1)) {
                x[k][j] = 0u;
              }
            }
          }
          break;
        }
        case kScan: {
          uint32_t neg = 0;  // bit 4k + j: the element's segment starts above
#pragma unroll
          for (int k = 0; k < kRW; ++k) {
            const int r = srow_base + k;
            uint32_t ss[4];
            side4(in, slot, a1, k, ss);
            int d[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int ls = (int)ss[j] - r * kLanes;
              d[j] = 4 * t + j - max(ls, 0);
              if (ls < 0) neg |= 1u << (4 * k + j);
            }
            masked_steps<4>(x[k], [&](int j, int sh) { return d[j] >= sh; },
                            a2);
            if (a3 > 0) publish_end<R>(bends, r, x[k][3], ss[3] / kLanes);
          }
          if (a3 > 0) {
            uint32_t c[kRW];
            row_carries<R>(bends, a3, srow_base, c);
#pragma unroll
            for (int k = 0; k < kRW; ++k)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if ((neg >> (4 * k + j)) & 1) x[k][j] += c[k];
            b ^= 1;
          }
          break;
        }
        case kPsum: {
#pragma unroll
          for (int k = 0; k < kRW; ++k) {
            uint32_t ex[4];
            warp_prefix<4>(x[k], ex);
            publish_end<R>(bends, srow_base + k, x[k][3], 0u);
          }
          uint32_t c[kRW];
          row_carries<R>(bends, 0, srow_base, c);
#pragma unroll
          for (int k = 0; k < kRW; ++k)
#pragma unroll
            for (int j = 0; j < 4; ++j) x[k][j] += c[k];
          b ^= 1;
          break;
        }
        case kCompact: {
          if constexpr (R == 512) {
            // the state before the stage into this block's buffer; after
            // the barrier each element's source word from the block that
            // holds it.  A warp's rows lie in one tile of 8.
            const int* m = in.meta + (row0 / R) * kMetaWords;
            const int base = __ldg(m + 1 + (srow_base >> 3));
            const int nsb = __ldg(m + 65 + (srow_base >> 3));
#pragma unroll
            for (int k = 0; k < kRW; ++k)
              *reinterpret_cast<uint4*>(buf + lay<R>(row_base + k, 4 * t)) =
                  make_uint4(x[k][0], x[k][1], x[k][2], x[k][3]);
            cluster_barrier();
#pragma unroll
            for (int k = 0; k < kRW; ++k) {
              uint32_t ci[4];
              side4(in, slot, a1, k, ci);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int d = (int)ci[j] - base;
                const int hi = d >> 7;
                uint32_t y = 0u;
                if (hi >= 0 && hi < 8 * nsb) {
                  const int cr = (base >> 7) + hi;
                  y = peer(buf, cr / kRB)[lay<R>(cr % kRB, d & 127)];
                }
                x[k][j] = y;
              }
            }
            b ^= 1;
          }
          break;
        }
        case kAddTouch:
        case kAddConst: {
          uint32_t c = (uint32_t)a1;
          if (op == kAddTouch) {
            c = ((in.u8mask >> (a1 - 1)) & 1)
                    ? __ldg(static_cast<const uint8_t*>(side_ptr(in, a1)) +
                            row0 * kLanes)
                    : __ldg(static_cast<const uint16_t*>(side_ptr(in, a1)) +
                            row0 * kLanes);
          }
#pragma unroll
          for (int k = 0; k < kRW; ++k)
#pragma unroll
            for (int j = 0; j < 4; ++j) x[k][j] += c;
          break;
        }
        default:
          break;
      }
      // the next section's v after the load (always stage 0), and its
      // sides, into the slots whose last reads in this section were this
      // stage's
      if (p == 0 && next >= 0) {
        fetch_v(in, vslot, next + srow_base);
        set_ticket(kSides, tk, committed);
        committed = (committed + 1) & 255;
      }
      for (; next >= 0 && ev < prog.nev && prog.ev_after[ev] == p; ++ev)
        start_fetch(in, slots, prog.ev_side[ev], prog.ev_slot[ev],
                    next + srow_base, committed, tk);
    }
#pragma unroll
    for (int k = 0; k < kRW; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] += x[k][j];
  }

  const Piece end = piece_at(pieces, blockIdx.x / B);
  uint32_t* o = out_ptr(in, end.out) + end.block * (long long)R * kLanes;
  uint32_t fold = 0;
#pragma unroll
  for (int k = 0; k < kRW; ++k) {
    uint32_t* at = o + (long long)(srow_base + k) * kLanes + 4 * t;
    if (end.kind == kStore) {
      *reinterpret_cast<uint4*>(at) =
          make_uint4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
    } else if (end.kind == kAdd) {
#pragma unroll
      for (int j = 0; j < 4; ++j) atomicAdd(at + j, acc[k][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) fold ^= acc[k][j];
  }
  if (end.kind == kDead && fold == kSinkKey) *sink = fold;
  // the peers may still read this block: none leaves before all are here
  // (their last reads of it returned, for the sums they store used them)
  cluster_meet();
}

// The side stage p reads at each of its elements, or 0.
int side_of(const int* w) {
  switch (w[0]) {
    case kLoad: return w[2];
    case kGather:
    case kC:
    case kMask:
    case kScan:
    case kCompact:
    case kAddFull: return w[1];
    default: return 0;
  }
}

// Plan the side slots: each side the program reads at its elements gets a
// slot of its own, fetched a section ahead, right after its last use in the
// section before; the fetches in the order of the stages they follow.
void plan_slots(Program* prog) {
  int first[kSides + 1], last[kSides + 1], slot_of[kSides + 1];
  for (int s = 0; s <= kSides; ++s) first[s] = last[s] = slot_of[s] = -1;
  for (int p = 0; p < prog->nops; ++p) {
    const int s = side_of(prog->w[p]);
    if (s < 1 || s > kSides) continue;
    if (first[s] < 0) first[s] = p;
    last[s] = p;
  }
  prog->nev = 0;
  for (int p = 0; p < prog->nops; ++p) {
    const int s = side_of(prog->w[p]);
    if (s < 1 || s > kSides || first[s] != p) continue;
    const int e = prog->nev++;
    slot_of[s] = e;
    prog->ev_after[e] = last[s];
    prog->ev_side[e] = s;
    prog->ev_slot[e] = e;
  }
  for (int i = 1; i < prog->nev; ++i)
    for (int j = i; j > 0 && prog->ev_after[j - 1] > prog->ev_after[j]; --j) {
      int* f[3] = {prog->ev_after, prog->ev_side, prog->ev_slot};
      for (int a = 0; a < 3; ++a) {
        const int tmp = f[a][j];
        f[a][j] = f[a][j - 1];
        f[a][j - 1] = tmp;
      }
    }
  for (int p = 0; p < prog->nops; ++p) {
    const int s = side_of(prog->w[p]);
    prog->slot[p] = s >= 1 && s <= kSides ? slot_of[s] : -1;
  }
}

// The launch configuration of the R-row instance, its shared memory
// allowed first (once, before any graph capture).
template <int R>
int configure(long long npieces, cudaStream_t stream, cudaLaunchConfig_t* cfg,
              cudaLaunchAttribute* attr) {
  constexpr size_t smem = sizeof(uint32_t) * Shape<R>::kSmemWords;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        sections_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  *cfg = {};
  cfg->gridDim = dim3((unsigned)(npieces * Shape<R>::B));
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = Shape<R>::B;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

template <int R>
int launch(const Inputs& in, Program prog, const long long* pieces,
           const long long* chain, uint32_t* sink, long long npieces,
           uint32_t init, cudaStream_t stream) {
  plan_slots(&prog);
  if (npieces <= 0) return 0;
  if (npieces * Shape<R>::B > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int err = configure<R>(npieces, stream, &cfg, attr);
  if (err != 0) return err;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, sections_kernel<R>, in, prog,
                                           pieces, chain, sink, init);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int R>
int entry(const void* v, const void* s1, const void* s2, const void* s3,
          const void* s4, const void* s5, const void* meta, void* out0,
          void* out1, void* out2, void* out3, const void* pieces,
          const void* chain, void* sink, const int* program,
          long long npieces, int nops, int v_f32, int u8mask, int init,
          void* stream) {
  if (nops < 1 || nops > kMaxOps) return (int)cudaErrorInvalidValue;
  Program prog{};
  prog.nops = nops;
  for (int p = 0; p < nops; ++p) {
    for (int k = 0; k < 4; ++k) prog.w[p][k] = program[4 * p + k];
    const int op = prog.w[p][0];
    if (op < 0 || op > kAddConst || (op == kLoad) != (p == 0) ||
        (R == 128 && (op == kC || op == kCompact)))
      return (int)cudaErrorInvalidValue;
  }
  const Inputs in{v,
                  {s1, s2, s3, s4, s5},
                  static_cast<const int*>(meta),
                  {static_cast<uint32_t*>(out0), static_cast<uint32_t*>(out1),
                   static_cast<uint32_t*>(out2), static_cast<uint32_t*>(out3)},
                  v_f32,
                  u8mask};
  return launch<R>(in, prog, static_cast<const long long*>(pieces),
                   static_cast<const long long*>(chain),
                   static_cast<uint32_t*>(sink), npieces, (uint32_t)init,
                   (cudaStream_t)stream);
}

}  // namespace

// The entry points launch on `stream` and return the CUDA error (0 on
// success; nothing is launched for npieces == 0).  Device pointers: v
// (rows, 128) f32 (v_f32 != 0) or int32, 16-byte aligned; s1..s5 (rows,
// 128) u16, or u8 where bit s-1 of u8mask is set (null where the program
// names none), aligned to 4 elements; meta (sections, 129) int32 or null
// (the compaction's windows; unused at 128 rows); out0..out3 (nout * R,
// 128) int32, filled with init by the caller where a piece adds into them
// (null past the outputs used); pieces (npieces, 4) int64 [block, chain
// offset, steps, kind | zeroed << 4 | first << 5 | output << 8]; chain the
// row0 of every piece's steps; sink one scratch word.  program is a HOST
// pointer to nops x 4 int32 (op and arguments, the header's list), checked
// by the caller; probe_sec128 refuses the C stage and the compaction.
extern "C" int probe_sec_route(const void* v, const void* s1, const void* s2,
                               const void* s3, const void* s4, const void* s5,
                               const void* meta, void* out0, void* out1,
                               void* out2, void* out3, const void* pieces,
                               const void* chain, void* sink,
                               const int* program, long long npieces,
                               int nops, int v_f32, int u8mask, int init,
                               void* stream) {
  return entry<512>(v, s1, s2, s3, s4, s5, meta, out0, out1, out2, out3,
                    pieces, chain, sink, program, npieces, nops, v_f32,
                    u8mask, init, stream);
}

extern "C" int probe_sec128(const void* v, const void* s1, const void* s2,
                            const void* s3, const void* s4, const void* s5,
                            const void* meta, void* out0, void* out1,
                            void* out2, void* out3, const void* pieces,
                            const void* chain, void* sink, const int* program,
                            long long npieces, int nops, int v_f32,
                            int u8mask, int init, void* stream) {
  return entry<128>(v, s1, s2, s3, s4, s5, meta, out0, out1, out2, out3,
                    pieces, chain, sink, program, npieces, nops, v_f32,
                    u8mask, init, stream);
}

// How many clusters of the `rows`-row instance (128 or 512) the card runs
// at once (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
extern "C" int probe_sec_clusters(int rows) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int n = 0;
  int err = rows == 512 ? configure<512>(132, nullptr, &cfg, attr)
                        : configure<128>(132, nullptr, &cfg, attr);
  if (err == 0)
    err = (int)(rows == 512 ? cudaOccupancyMaxActiveClusters(
                                  &n, sections_kernel<512>, &cfg)
                            : cudaOccupancyMaxActiveClusters(
                                  &n, sections_kernel<128>, &cfg));
  return err == 0 ? n : -err;
}
