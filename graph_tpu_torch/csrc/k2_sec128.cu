// probe_sec128: the K2 stage programs (see k2_stage_probes.cu for the
// stages and the epilogue) on sections of 128 rows x 128 lanes, written for
// Hopper.  Replaces scripts/perf_k2_sec128.py:159 (k2_128) and :218
// (k2_quad, four outputs), and perf_transpose.py:33's t128x8 and taa128x4.
//
// Bound: bytes.  Every step's rows of v and of each side the program reads
// in full, one word of each touched side, each out block written once
// (k2_stage_kernels.moved_bytes); the int32 adds are far below the card's
// rate.  At perf_k2_sec128.py's 32 sections that is 2.3 MB, 0.0025 ms at
// 3.35 TB/s: less than a launch costs, so such a call is held back by the
// launch and by each section's chain of dependent stages, not by bytes.
//
// The design.  A section is split over the two blocks of a cluster, 64 rows
// a block, 512 threads a block:
// - Warp w owns kRW rows, lane t of it lanes 4t .. 4t+3 of each: the state
//   and its running sums are registers.  In a 128-row section every side
//   word a thread reads lies at one of its own elements, in both layouts
//   (only add_touch's (row0, 0) and the scan's row ends at lane 127, lane
//   31's, differ), so no stage needs another thread's side words.
// - Row-local stages take no block barrier: masks and adds in registers,
//   the scans' and prefix sums' lane steps by warp shuffles, the gathers
//   through the warp's own rows of a shared buffer between two
//   __syncwarp().  The scans run the masked steps: their closed form holds
//   only where the start words are true segment starts.
// - Stages that cross rows (t, ti, the row carries of scan and psum) take
//   one barrier each, of the cluster: each thread stores what others need
//   into buffer b (the transpose stores 16 B a thread straight into the
//   block that holds the rows, remote or not, through an XOR swizzle free
//   of bank conflicts), the cluster syncs once, each thread reads, and b
//   flips.  With two buffers that is safe: a crossing stores into the
//   buffer last stored two crossings back, whose readers all passed the
//   barrier between; the gathers use the last crossing's buffer, into which
//   nothing is stored until the crossing after next.  The cluster also
//   syncs once at the start, so that no block stores into a peer that has
//   not begun, and once at the end, so that none leaves while its peer may
//   still read it.
// - Each side has a slot of shared memory, filled by cp.async once a
//   section and waited for (wait_group, no barrier) before its first use.
//   A longer piece fetches the next section's sides during this one, each
//   right after its last use here.  A thread's words of a slot are its
//   own: it alone fetches them and reads them, and no peer touches the
//   slots.  So a refill takes no barrier: it follows the thread's own last
//   read of the slot in program order (the asm's memory clobber keeps the
//   compiler from moving the read past it), and the slot's fetch for this
//   section was waited for before that read, so no two copies into one
//   word are ever in flight (cp.async orders none between them).
// - 512 threads leave 128 registers a thread: no spills.  Shared memory a
//   block: two state buffers, the row ends, five 16 KB slots (149.5 KB).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 128;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOps = 24;
constexpr int kSides = 5;
constexpr int kOuts = 4;
constexpr uint32_t kSinkKey = 0x9e3779b9u;
// A section over a cluster of kBlocks blocks, kRB rows each, kRW rows a
// warp; two state buffers, the row ends and their segment-start rows
// (double too), and a slot a side (4 u16 a row a thread).
constexpr int kBlocks = 2;
constexpr int kRB = kRows / kBlocks;
constexpr int kRW = kRB / kWarps;
constexpr int kBuf = kRB * kLanes;
constexpr int kSlotWords = kThreads * kRW * 2;
constexpr int kSmemWords = 2 * kBuf + 4 * kRows + kSides * kSlotWords;

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

// Word of element (r, c) of a block's state buffer (r its local row):
// 16-byte groups XOR-swizzled by row, so that a warp's 16-byte stores along
// a row and its loads down a column of four-row groups meet few bank
// conflicts (none at 16 bytes).
__device__ __forceinline__ int swz(int r, int c) {
  return r * kLanes + ((((c >> 2) ^ (r >> 2)) & 7) << 2) +
         ((c >> 2) & ~7) * 4 + (c & 3);
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
// At a side's first use in a section at most the other four sides' fetches
// were committed after its own (plan_slots orders them), so n <= 4.
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 1: wait_group<1>(); break;
    case 2: wait_group<2>(); break;
    case 3: wait_group<3>(); break;
    case 4: wait_group<4>(); break;
    default: wait_group<0>(); break;
  }
}

// Side stream s (1..5), output o and element e of four: selects, so that
// nothing is copied to the stack to be indexed.
__device__ __forceinline__ const void* side_ptr(const Inputs& in, int s) {
  return s == 1 ? in.side[0] : s == 2 ? in.side[1] : s == 3 ? in.side[2]
       : s == 4 ? in.side[3] : in.side[4];
}
__device__ __forceinline__ uint32_t* out_ptr(const Inputs& in, int o) {
  return o == 0 ? in.out[0] : o == 1 ? in.out[1] : o == 2 ? in.out[2]
                                                          : in.out[3];
}
__device__ __forceinline__ uint32_t pick(const uint32_t q[4], int e) {
  return e == 0 ? q[0] : e == 1 ? q[1] : e == 2 ? q[2] : q[3];
}

__device__ __forceinline__ int warp_id() { return (int)(threadIdx.x >> 5); }
__device__ __forceinline__ int lane_id() { return (int)(threadIdx.x & 31); }

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

// A 128-vector a warp holds, q[j] at position 4t + j: `steps` masked
// Hillis-Steele steps sh = 1, 2, 4, ..: q[p] += q[p - sh] where d[p] >= sh,
// every step reading the previous step's values.  d[p] <= p, so no step
// reads below position 0.
__device__ __forceinline__ void masked_steps(uint32_t q[4], const int d[4],
                                             int steps) {
#pragma unroll
  for (int s = 0; s < 7; ++s) {
    if (s < steps) {
      const int sh = 1 << s;
      uint32_t p[4];
      if (sh == 1) {
        p[0] = __shfl_up_sync(~0u, q[3], 1);
        p[1] = q[0];
        p[2] = q[1];
        p[3] = q[2];
      } else if (sh == 2) {
        p[0] = __shfl_up_sync(~0u, q[2], 1);
        p[1] = __shfl_up_sync(~0u, q[3], 1);
        p[2] = q[0];
        p[3] = q[1];
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) p[j] = __shfl_up_sync(~0u, q[j], sh >> 2);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (d[j] >= sh) q[j] += p[j];
    }
  }
}

// The inclusive sums of a 128-vector a warp holds as in masked_steps, with
// each position's exclusive sum in ex (wrapping int32).
__device__ __forceinline__ void warp_prefix(uint32_t q[4], uint32_t ex[4]) {
  const int t = lane_id();
  ex[0] = 0u;
  ex[1] = q[0];
  ex[2] = q[0] + q[1];
  ex[3] = ex[2] + q[2];
  const uint32_t total = ex[3] + q[3];
  uint32_t inc = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(~0u, inc, o);
    if (t >= o) inc += y;
  }
  const uint32_t before = inc - total;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ex[j] += before;
    q[j] += ex[j];
  }
}

// The group number of a slot's latest fetch (selects, so that tk stays in
// registers).
__device__ __forceinline__ int ticket(int slot, const int tk[kSides]) {
  return slot == 0 ? tk[0] : slot == 1 ? tk[1] : slot == 2 ? tk[2]
       : slot == 3 ? tk[3] : tk[4];
}

// Fetch side s into a slot as the next group, and note its number.
__device__ __forceinline__ void start_fetch(const Inputs& in,
                                            uint32_t* slots, int s, int slot,
                                            long long r0, int& committed,
                                            int tk[kSides]) {
  fetch(in, slots + slot * kSlotWords, s, r0);
#pragma unroll
  for (int c = 0; c < kSides; ++c)
    if (c == slot) tk[c] = committed;
  ++committed;
}

__global__ void __launch_bounds__(kThreads, 1)
    sec128_kernel(Inputs in, Program prog,
                  const long long* __restrict__ pieces,
                  const long long* __restrict__ chain,
                  uint32_t* __restrict__ sink, uint32_t init) {
  constexpr int RB = kRB, RW = kRW;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* const bufs = smem;                    // 2 x kBuf
  uint32_t* const rend = smem + 2 * kBuf;         // 2 x kRows: row ends
  uint32_t* const rsr = rend + 2 * kRows;         // 2 x kRows: their starts
  uint32_t* const slots = rsr + 2 * kRows;        // kSides x kSlotWords
  const int w = warp_id(), t = lane_id();
  const int a = (int)cg::this_cluster().block_rank();
  const int row_base = RW * w;        // this warp's first local row
  const int srow_base = a * RB + row_base;  // .. as a row of the section
  const Piece pc = piece_at(pieces, blockIdx.x / kBlocks);
  uint32_t start = 0;
  if (pc.kind == kStore) start = pc.zeroed ? 0u : init;
  if (pc.kind == kAdd && pc.first && pc.zeroed) start = 0u - init;
  uint32_t acc[RW][4], x[RW][4];
#pragma unroll
  for (int k = 0; k < RW; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = start, x[k][j] = 0u;

  int b = 0;       // the buffer of the next crossing stage
  int committed = 0;  // cp.async groups committed; ticket: a slot's latest
  int tk[kSides] = {0, 0, 0, 0, 0};
  // the first section's sides (a longer piece fetches the next section's
  // during this one)
  if (pc.count > 0) {
    const long long row0 = __ldg(chain + pc.off);
    for (int e = 0; e < prog.nev; ++e)
      start_fetch(in, slots, prog.ev_side[e], prog.ev_slot[e],
                  row0 + srow_base, committed, tk);
  }
  cg::this_cluster().sync();  // the peer has begun: it may be stored into

  for (int sec = 0; sec < pc.count; ++sec) {
    const long long row0 = __ldg(chain + pc.off + sec);
    const long long r0 = row0 + srow_base;  // this thread's first row
    const long long next =
        sec + 1 < pc.count ? __ldg(chain + pc.off + sec + 1) : -1;
    int ev = 0;
    for (int p = 0; p < prog.nops; ++p) {
      const int op = prog.w[p][0], a1 = prog.w[p][1], a2 = prog.w[p][2],
                a3 = prog.w[p][3];
      const int sl = prog.slot[p];
      const uint32_t* slot = nullptr;
      if (sl >= 0) {
        wait_pending(committed - 1 - ticket(sl, tk));
        slot = slots + sl * kSlotWords;
      }
      // the next crossing's buffer, and the last one's
      uint32_t* const buf = bufs + b * kBuf;
      uint32_t* const last = bufs + (b ^ 1) * kBuf;
      switch (op) {
        case kLoad: {
#pragma unroll
          for (int k = 0; k < RW; ++k) {
            const long long e = (r0 + k) * kLanes + 4 * t;
            if (!in.v_f32) {
              const int4 q = __ldg(reinterpret_cast<const int4*>(
                  static_cast<const int*>(in.v) + e));
              x[k][0] = (uint32_t)q.x;
              x[k][1] = (uint32_t)q.y;
              x[k][2] = (uint32_t)q.z;
              x[k][3] = (uint32_t)q.w;
              continue;
            }
            const float4 f4 = __ldcs(reinterpret_cast<const float4*>(
                static_cast<const float*>(in.v) + e));
            float f[4] = {f4.x, f4.y, f4.z, f4.w};
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
          // through this warp's rows of the last crossing's buffer
#pragma unroll
          for (int k = 0; k < RW; ++k)
            *reinterpret_cast<uint4*>(last + swz(row_base + k, 4 * t)) =
                make_uint4(x[k][0], x[k][1], x[k][2], x[k][3]);
          __syncwarp();
#pragma unroll
          for (int k = 0; k < RW; ++k) {
            uint32_t idx[4];
            if (a1) {
              side4(in, slot, a1, k, idx);
#pragma unroll
              for (int j = 0; j < 4; ++j) idx[j] = (idx[j] >> a2) & 127u;
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                idx[j] = (uint32_t)(4 * t + j + a2) & 127u;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
              x[k][j] = last[swz(row_base + k, (int)idx[j])];
          }
          __syncwarp();
          break;
        }
        case kT:
        case kTI: {
          // a 128-row section's T and T' are both the plain transpose:
          // element (i, 4t + j) of this thread goes to row 4t + j, lane i,
          // which block (4t + j) / RB holds.  Each thread stores its rows'
          // four-row groups there (remote stores need no reply), the
          // cluster syncs once, and each thread reads its own rows back.
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = 4 * t + j;
            uint32_t* dst = peer(buf, r / RB);
#pragma unroll
            for (int m = 0; m < RW / 4; ++m)
              *reinterpret_cast<uint4*>(dst +
                                        swz(r % RB, srow_base + 4 * m)) =
                  make_uint4(x[4 * m][j], x[4 * m + 1][j], x[4 * m + 2][j],
                             x[4 * m + 3][j]);
          }
          cg::this_cluster().sync();
#pragma unroll
          for (int k = 0; k < RW; ++k) {
            const uint4 c = *reinterpret_cast<const uint4*>(
                buf + swz(row_base + k, 4 * t));
            x[k][0] = c.x;
            x[k][1] = c.y;
            x[k][2] = c.z;
            x[k][3] = c.w;
          }
          b ^= 1;
          break;
        }
        case kMask:
        case kAddFull: {
#pragma unroll
          for (int k = 0; k < RW; ++k) {
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
          for (int k = 0; k < RW; ++k) {
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
            masked_steps(x[k], d, a2);
            if (a3 > 0 && t == 31) {
              rend[b * kRows + row_base + k] = x[k][3];
              rsr[b * kRows + row_base + k] = ss[3] / kLanes;
            }
          }
          if (a3 > 0) {
            // every section row's end and segment-start row: rows 4t .. 4t+3
            cg::this_cluster().sync();
            const int r = 4 * t, owner = r / RB, lr = b * kRows + r % RB;
            const uint4 re =
                *reinterpret_cast<const uint4*>(peer(rend, owner) + lr);
            const uint4 rs =
                *reinterpret_cast<const uint4*>(peer(rsr, owner) + lr);
            uint32_t run[4] = {re.x, re.y, re.z, re.w};
            const int d[4] = {r - (int)rs.x, r + 1 - (int)rs.y,
                              r + 2 - (int)rs.z, r + 3 - (int)rs.w};
            masked_steps(run, d, a3);
#pragma unroll
            for (int k = 0; k < RW; ++k) {
              // run[r - 1]: lane (r - 1) / 4, element (r - 1) & 3; section
              // row 0 never takes a carry
              const int rp = max(srow_base + k - 1, 0);
              const uint32_t c = __shfl_sync(~0u, pick(run, rp & 3), rp >> 2);
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if ((neg >> (4 * k + j)) & 1) x[k][j] += c;
            }
            b ^= 1;
          }
          break;
        }
        case kPsum: {
#pragma unroll
          for (int k = 0; k < RW; ++k) {
            uint32_t ex[4];
            warp_prefix(x[k], ex);
            if (t == 31) rend[b * kRows + row_base + k] = x[k][3];
          }
          cg::this_cluster().sync();
          const int r = 4 * t;
          const uint4 re = *reinterpret_cast<const uint4*>(
              peer(rend, r / RB) + b * kRows + r % RB);
          uint32_t tot[4] = {re.x, re.y, re.z, re.w}, before[4];
          warp_prefix(tot, before);
#pragma unroll
          for (int k = 0; k < RW; ++k) {
            // the rows before section row rr: lane rr / 4, element rr & 3
            const int rr = srow_base + k;
            const uint32_t c = __shfl_sync(~0u, pick(before, rr & 3), rr >> 2);
#pragma unroll
            for (int j = 0; j < 4; ++j) x[k][j] += c;
          }
          b ^= 1;
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
          for (int k = 0; k < RW; ++k)
#pragma unroll
            for (int j = 0; j < 4; ++j) x[k][j] += c;
          break;
        }
        default:
          break;  // c and compact: 512-row sections only (the host refuses)
      }
      // the next section's sides, into the slots whose last reads in this
      // section were this stage's
      for (; next >= 0 && ev < prog.nev && prog.ev_after[ev] == p; ++ev)
        start_fetch(in, slots, prog.ev_side[ev], prog.ev_slot[ev],
                    next + srow_base, committed, tk);
    }
#pragma unroll
    for (int k = 0; k < RW; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] += x[k][j];
  }

  uint32_t* o = out_ptr(in, pc.out) + pc.block * (long long)kRows * kLanes;
  uint32_t fold = 0;
#pragma unroll
  for (int k = 0; k < RW; ++k) {
    uint32_t* at = o + (long long)(srow_base + k) * kLanes + 4 * t;
    if (pc.kind == kStore) {
      *reinterpret_cast<uint4*>(at) =
          make_uint4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
    } else if (pc.kind == kAdd) {
#pragma unroll
      for (int j = 0; j < 4; ++j) atomicAdd(at + j, acc[k][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) fold ^= acc[k][j];
  }
  if (pc.kind == kDead && fold == kSinkKey) *sink = fold;
  cg::this_cluster().sync();  // the peer may still read this block
}

// The side stage p reads at each of its elements, or 0.
int side_of(const int* w) {
  switch (w[0]) {
    case kLoad: return w[2];
    case kGather:
    case kMask:
    case kScan:
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

int launch(const Inputs& in, Program prog, const long long* pieces,
           const long long* chain, uint32_t* sink, long long npieces,
           uint32_t init, cudaStream_t stream) {
  plan_slots(&prog);
  if (npieces <= 0) return 0;
  const long long grid = npieces * kBlocks;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  constexpr size_t smem = sizeof(uint32_t) * kSmemWords;
  static bool attr_set = false;  // once, before any graph capture
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        sec128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
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
  attr[0].val.clusterDim.x = kBlocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, sec128_kernel, in, prog,
                                           pieces, chain, sink, init);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the CUDA error (0 on success; nothing
// is launched for npieces == 0).  Arguments as probe_sec_route's
// (k2_stage_probes.cu), with 128-row sections and up to four outputs; meta
// is unused (compaction is a 512-row stage).  program is a HOST pointer to
// nops x 4 int32, checked by the caller; the C stage and the compaction
// are refused.
extern "C" int probe_sec128(const void* v, const void* s1, const void* s2,
                            const void* s3, const void* s4, const void* s5,
                            const void* meta, void* out0, void* out1,
                            void* out2, void* out3, const void* pieces,
                            const void* chain, void* sink, const int* program,
                            long long npieces, int nops, int v_f32,
                            int u8mask, int init, void* stream) {
  (void)meta;
  if (nops < 1 || nops > kMaxOps) return (int)cudaErrorInvalidValue;
  Program prog{};
  prog.nops = nops;
  for (int p = 0; p < nops; ++p) {
    for (int k = 0; k < 4; ++k) prog.w[p][k] = program[4 * p + k];
    if (prog.w[p][0] == kC || prog.w[p][0] == kCompact ||
        prog.w[p][0] < 0 || prog.w[p][0] > kAddConst)
      return (int)cudaErrorInvalidValue;
  }
  const Inputs in{v,
                  {s1, s2, s3, s4, s5},
                  {static_cast<uint32_t*>(out0), static_cast<uint32_t*>(out1),
                   static_cast<uint32_t*>(out2), static_cast<uint32_t*>(out3)},
                  v_f32,
                  u8mask};
  return launch(in, prog, static_cast<const long long*>(pieces),
                static_cast<const long long*>(chain),
                static_cast<uint32_t*>(sink), npieces, (uint32_t)init,
                (cudaStream_t)stream);
}
