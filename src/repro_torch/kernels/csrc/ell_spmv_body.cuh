// Generalized ELL SpMV / multi-query SpMM for Hopper (sm_90a): the kernel's
// body, templated on the per-edge process (included by ell_spmv.cu and by
// the sources generated for traced processes).
//
// Replaces the TPU kernel src/repro/kernels/ell_spmv.py::ell_spmv_pallas,
// both of its grids: the single-query grid (Q = 1) and the block_queries
// multi-query SpMM grid (Q > 1, lanewise programs), with its destination-
// property operand.  For every packed ELL row r and query lane q:
//
//   y[r, q] = REDUCE_s { process(msg[cols[r, s], q], vals[r, s], dprop[r, q])
//                        : mask[r, s] && active[cols[r, s]] }
//   recv[r] = any_s (mask[r, s] && active[cols[r, s]])
//
// REDUCE is add, min or max; a row with no valid slot gets the reduce
// identity and recv = 0; a NaN among a row's values makes its min or max
// NaN, as torch.amin/amax do.  process is the functor P the kernel is
// templated on (ell_process.cuh), as Pallas traces the program's own
// process_message into its body: one of the five shipped forms (msg,
// msg + 1, msg + edge, msg * edge, (edge - msg * d) * msg; ell_spmv.cu
// instantiates them) or one that kernels/process_expr.py generates from a
// program's traced process_message and kernels/ell_spmv.py builds at its
// first launch.  P::kReadsEdge says whether it reads vals, P::kReadsDst
// whether it reads the destination row's property d = dprop[r, q] (dprop is
// [n_pad, Kd], Kd = 1 or Q, already in packed-row order).  Types: the
// message, edge value, destination property and result each have their own
// (an Operands; the shipped forms: float, half or int32 for all four; a
// generated instance: float, half, bfloat16, int32, int16, int8 or uint8,
// as its trace says, or double for a message passed through and summed:
// the add reduce over GAP's float64 path counts, on both grids).  The sum is kept in the result type, except that a
// half or bfloat16 result (a shipped half form's, a generated instance's)
// is summed in float and rounded once into y, as the TPU kernel's jnp.sum
// sums a tile of them in float32 and as the plain version sums a row; float
// arithmetic is rounded op by op (no contraction into FMAs), as the plain
// version rounds it.
//
// A process that mixes the lane axis of a [n_src, K] message (a lane sum or
// max, a select, a result of K_out = 1; the reference's single-query grid
// with its resident message, ell_spmv.py:192) runs on the lane-vector grid
// (lanes_kernel below).  What bounds it: the same bytes as below, and the
// gathers of the K-value messages, each a random read of K * sizeof(M)
// bytes from L1 or L2 (the dot score on RMAT-20, K = 16: 942 MB of gathers
// against 143 MB of bytes; CF's process at the Netflix Prize's size: 2,970
// MB against 437 MB).  The first version (a group of up to 32
// threads a row, 4-byte lane loads, 4 slots a step along a chain of
// dependent loads, every thread of the group loading the same cols, a
// group for every row whatever its extent) ran at 0.09-0.10 of the byte
// bound.  This one:
// * 16-byte lane vectors: a team of T threads holds a message, V
//   contiguous lanes a thread (16 bytes where K allows), loaded W lanes at
//   a time (the widest load that divides V and K: K = 3 and K = 33 take
//   scalar loads);
// * a row's slots spread over the teams of its threads: a row of G
//   threads has G / T teams, team t takes slot u * (G / T) + t of each
//   step for u < U; a lane sum is an in-thread sum over V lanes and log2 T
//   shuffles within the team; the teams' accumulators combine once, at
//   the row's end;
// * coalesced slot metadata: the row's threads load consecutive cols (and
//   vals, and mask), one slot a thread, evict-first, and each the active
//   flag of its own col; shuffles hand the slots to the teams;
// * U = 1-4 slots a team a step (64 bytes of message loads in flight a
//   thread), loaded before the functor applies to any;
// * row classes: G is the fewest teams whose step covers the row, up to a
//   warp, so short rows share a warp (32 / G rows) and long rows take one
//   each, from a per-graph table (RowSegments.lane_table) over the
//   degree-sorted extents;
// * a pass over the active flags before the launch finds whether every
//   source is active, as the single-query grid's cooperative prologue
//   does (then no slot reads a flag, which takes a dependent load off each
//   step); registers bounded for 6 blocks of 256 threads an SM (the warps
//   in flight set the pace);
// * messages through the read-only path with no L2 policy: an evict-last
//   hint on them changed no row by more than 1% (PERF.md).
// Measured (H100 80GB HBM3, 700 W; the card's time a call,
// tools/time_ell_kernel.py; the first version -> this one): the dot score
// on RMAT-20 0.4674 -> 0.2433 ms, CF's process at the Netflix Prize's size
// 1.2768 -> 0.6255 ms, against gather floors of 0.1279 and 0.2560 ms (the
// same gathers in the same order with nothing else, tools/gather_floor.py).
//
// What bounds it: bytes, counted as this graph needs them.  Per valid slot
// 4 bytes of cols (and 4 of vals for a process that reads the edge), 4 bytes
// of row extent per packed row, msg and active read once, y and recv
// written once.  On the RMAT scale-20 graph of chip_smoke.py (9.2% of the
// ELL slots valid) that is 73.5 MB at Q = 1 (0.022 ms at 3.35 TB/s) and
// 132 MB at Q = 8; on the road grid (1,048,576 rows of 2-4 slots, width 8)
// 31.5 MB at PageRank (0.0094 ms).  What the card pays for, though, is the
// gathers: each slot's message and active flag are random reads of a
// 32-byte sector from L1 or L2, and on RMAT-20 they, not the bytes from
// memory, set the pace.  On the road grid the data (cols in 32-byte rows,
// half of each read) fits the 50 MB L2, and what sets the pace is the chain
// of dependent loads a warp waits on (extent, cols, active flags, messages)
// and the launch's fixed cost.  The first version of this kernel (one warp
// per row, every slot to the row's width, a chain of dependent loads per
// slot) ran at 16x the RMAT bound.
//
// Design:
// * The kernel never reads a slot at or beyond row_end[r], one past the
//   row's last set slot, and where the mask is a prefix of every row (every
//   graph build_ell makes) it does not read the mask at all.
// * Lane classes: each row gets G lanes, G in {1, 2, 4, 8, 16, 32}, the
//   least that covers its extent at 4 slots a lane; a warp serves 32 / G
//   rows.  Packed rows are degree-sorted, so a few row segments cover each
//   G; a table of segments (first row, end row, G, first warp), made once
//   per graph by the wrapper (kernels/ell_spmv.py), maps each warp of rows
//   to its rows.  The query-tiled grid has its own table, with G >= 2.
// * A lane loads its next 4 slots' cols (and vals, and mask where it is
//   read) with one 16-byte load, evict-first, so that the ELL arrays, read
//   once, do not push the gathered messages out of L1; then the 4 slots'
//   active flags, then the messages of the active ones only.  The 8-query
//   tile keeps 1 slot a lane: its message rows take the registers.
// * The one-lane class (rows of 0-4 slots: the road grid, RMAT's tail) has
//   a path of its own at Q = 1 (lane_row): a lane per row, 32 consecutive
//   rows a warp; a row with a set slot loads its cols beside its extent;
//   the edge values are read only for rows with an active source unless
//   every source is active.
// * Launch kinds: a table with a row of more than 4 slots gets one
//   cooperative launch of as many blocks as fit on the card: the blocks
//   first find whether every source is active, cross a grid barrier, and
//   then walk the (warp of rows, query tile) pairs in turn; when every
//   source is active (PageRank, a full frontier) no slot reads an active
//   flag, which halves RMAT's gathers.  (An all-active byte written by
//   torch.all before a plain launch, in place of the barrier, was 6-7%
//   slower at PageRank and up to 17% at a 10% frontier on an H100;
//   PERF.md.)  A table whose rows are all in the one-lane class gets a
//   plain launch of a warp for each 32 rows and reads the flags: the
//   pass and the barrier cost the card 5.1-5.8 us (6.38-7.00 us against
//   1.25 for an empty launch of the 660 resident blocks;
//   tools/ell_launch_cost.py), more than the flags they spare the road
//   grid's PageRank (PERF.md).
// * Measured on the road grid (H100 80GB HBM3, 700 W; the kernel's device
//   time a launch, tools/time_ell_kernel.py; the previous design -> this
//   one): PageRank 0.0381 -> 0.0183 ms, BFS on its recorded frontiers
//   0.0392 -> 0.0202, SSSP 0.0456 -> 0.0224; torch.sparse.mm 0.034.  The
//   data fits the L2, and a launch takes 2.5x its byte bound.  A call's
//   host time in the wrapper (38-69 us) is more than the kernel's there,
//   so the events of back-to-back calls time the host.
// * Each lane keeps up to QT query accumulators (one query tile of up to
//   8); the G lanes of a row combine them with __shfl_xor_sync, so nothing
//   is carried between blocks and no atomics are needed.  This takes the
//   place of the Pallas grid's innermost slot axis.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "ell_process.cuh"

namespace {

enum Reduce { kAdd = 0, kMin = 1, kMax = 2 };
enum DType {
  kF32 = 0, kF16 = 1, kI32 = 2, kBF16 = 3, kI8 = 4, kI16 = 5, kU8 = 6,
  kF64 = 7
};

// The types of one instance: message, edge value, destination property,
// result and the accumulator of the reduce (the result's type, or float for
// a half or bfloat16 result: ell_spmv.cu's half forms, a generated
// instance's half or bfloat16 result).
template <typename M_, typename E_, typename D_, typename R_,
          typename A_ = R_>
struct Operands {
  using M = M_;
  using E = E_;
  using D = D_;
  using R = R_;
  using A = A_;
};

// A value from one type to another: the same type as it is; half and
// bfloat16 to and from float, to nearest even.
template <typename To, typename From>
__device__ __forceinline__ To convert(From x) { return x; }
template <>
__device__ __forceinline__ float convert<float, __half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ __half convert<__half, float>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ float convert<float, __nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16, float>(
    float x) {
  return __float2bfloat16_rn(x);
}
// Launch flags: the mask is a prefix of every row (do not read it); cols,
// vals and mask rows allow 4-slot vector loads; message rows allow 4-value
// vector loads (the lane-vector grid: P::kLoad-value loads); active allows
// 16-flag vector loads; every row is in the one-lane class (a plain launch
// sized to the rows, no all-active pass).
enum Flags {
  kMaskIsPrefix = 1,
  kVecSlots = 2,
  kVecMsg = 4,
  kVecActive = 8,
  kShortRows = 16
};

// Slots a lane loads per step: 4 (one 16-byte load of cols) for a single
// query; 1 for the 8-query tile, whose 8-value message rows take the
// registers that would keep more slots in flight (its rows keep the lanes
// of the table, each lane stepping one slot at a time).
template <int QT>
__host__ __device__ constexpr int slots_per_lane() { return QT == 1 ? 4 : 1; }
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int R>
__device__ __forceinline__ T identity() {
  if (R == kAdd) return Num<T>::zero();
  if (R == kMin) return Num<T>::top();
  return Num<T>::bottom();
}

template <typename T, int R>
__device__ __forceinline__ T combine(T a, T b) {
  if (R == kAdd) return Num<T>::add(a, b);
  if (R == kMin) return Num<T>::min(a, b);
  return Num<T>::max(a, b);
}

// Read-only loads (the non-coherent path: nothing the launch reads is
// written during it).
__device__ __forceinline__ float ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ int ro(const int* p) { return __ldg(p); }
__device__ __forceinline__ uint8_t ro(const uint8_t* p) { return __ldg(p); }
__device__ __forceinline__ __half ro(const __half* p) {
  return __ushort_as_half(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ __nv_bfloat16 ro(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ int8_t ro(const int8_t* p) {
  return static_cast<int8_t>(__ldg(reinterpret_cast<const char*>(p)));
}
__device__ __forceinline__ int16_t ro(const int16_t* p) {
  return static_cast<int16_t>(__ldg(reinterpret_cast<const short*>(p)));
}
__device__ __forceinline__ double ro(const double* p) { return __ldg(p); }

// Streaming loads of the ELL arrays, which each launch reads once: loaded
// evict-first, so they do not push the gathered messages out of L1.
__device__ __forceinline__ int st(const int* p) { return __ldcs(p); }
__device__ __forceinline__ float st(const float* p) { return __ldcs(p); }
__device__ __forceinline__ __half st(const __half* p) {
  return __ushort_as_half(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ uint8_t st(const uint8_t* p) {
  return static_cast<uint8_t>(__ldcs(reinterpret_cast<const char*>(p)));
}
__device__ __forceinline__ __nv_bfloat16 st(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcs(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ int8_t st(const int8_t* p) {
  return static_cast<int8_t>(__ldcs(reinterpret_cast<const char*>(p)));
}
__device__ __forceinline__ int16_t st(const int16_t* p) {
  return static_cast<int16_t>(__ldcs(reinterpret_cast<const short*>(p)));
}
__device__ __forceinline__ double st(const double* p) { return __ldcs(p); }

// Four consecutive values from an address aligned to four of them:
// STREAM for the ELL arrays, else the read-only path (message rows).
template <bool STREAM>
__device__ __forceinline__ void ld4(const int* p, int* v) {
  const int4* q = reinterpret_cast<const int4*>(p);
  const int4 w = STREAM ? __ldcs(q) : __ldg(q);
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}
template <bool STREAM>
__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 w = STREAM ? __ldcs(q) : __ldg(q);
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}
template <bool STREAM>
__device__ __forceinline__ void ld4(const __half* p, __half* v) {
  const uint2* q = reinterpret_cast<const uint2*>(p);
  const uint2 w = STREAM ? __ldcs(q) : __ldg(q);
  v[0] = __ushort_as_half(static_cast<unsigned short>(w.x & 0xffffu));
  v[1] = __ushort_as_half(static_cast<unsigned short>(w.x >> 16));
  v[2] = __ushort_as_half(static_cast<unsigned short>(w.y & 0xffffu));
  v[3] = __ushort_as_half(static_cast<unsigned short>(w.y >> 16));
}
template <bool STREAM>
__device__ __forceinline__ void ld4(const uint8_t* p, uint8_t* v) {
  const unsigned* q = reinterpret_cast<const unsigned*>(p);
  const unsigned w = STREAM ? __ldcs(q) : __ldg(q);
  v[0] = w & 0xffu; v[1] = (w >> 8) & 0xffu;
  v[2] = (w >> 16) & 0xffu; v[3] = w >> 24;
}
template <bool STREAM>
__device__ __forceinline__ void ld4(const __nv_bfloat16* p,
                                    __nv_bfloat16* v) {
  const uint2* q = reinterpret_cast<const uint2*>(p);
  const uint2 w = STREAM ? __ldcs(q) : __ldg(q);
  v[0] = __ushort_as_bfloat16(static_cast<unsigned short>(w.x & 0xffffu));
  v[1] = __ushort_as_bfloat16(static_cast<unsigned short>(w.x >> 16));
  v[2] = __ushort_as_bfloat16(static_cast<unsigned short>(w.y & 0xffffu));
  v[3] = __ushort_as_bfloat16(static_cast<unsigned short>(w.y >> 16));
}
template <bool STREAM>
__device__ __forceinline__ void ld4(const int16_t* p, int16_t* v) {
  const uint2* q = reinterpret_cast<const uint2*>(p);
  const uint2 w = STREAM ? __ldcs(q) : __ldg(q);
  v[0] = static_cast<int16_t>(w.x & 0xffffu);
  v[1] = static_cast<int16_t>(w.x >> 16);
  v[2] = static_cast<int16_t>(w.y & 0xffffu);
  v[3] = static_cast<int16_t>(w.y >> 16);
}
// Four doubles are two 16-byte loads (from an address aligned to 16 bytes).
template <bool STREAM>
__device__ __forceinline__ void ld4(const double* p, double* v) {
  const double2* q = reinterpret_cast<const double2*>(p);
  const double2 a = STREAM ? __ldcs(q) : __ldg(q);
  const double2 b = STREAM ? __ldcs(q + 1) : __ldg(q + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
template <bool STREAM>
__device__ __forceinline__ void ld4(const int8_t* p, int8_t* v) {
  uint8_t u[4];
  ld4<STREAM>(reinterpret_cast<const uint8_t*>(p), u);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = static_cast<int8_t>(u[i]);
}

// The qn (<= QT) message values of one source row's query tile.
template <typename T, int QT>
__device__ __forceinline__ void load_msg(const T* p, int qn, bool vec,
                                         T* m) {
  if (QT % 4 == 0 && vec) {  // qn is then a multiple of 4
#pragma unroll
    for (int k = 0; k < QT; k += 4) {
      if (k < qn) ld4<false>(p + k, m + k);
    }
  } else {
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      if (j < qn) m[j] = ro(p + j);
    }
  }
}

struct Args {
  const int* cols;
  const void* vals;
  const uint8_t* mask;
  const void* msg;
  const uint8_t* active;
  const void* dprop;
  const int* row_end;
  const int4* segs;  // (first row, end row, lanes per row, first warp)
  void* y;
  int8_t* recv;
  // The cooperative launch's barrier and all-active flag and the lane
  // grid's tag word, 5 words that carry over from launch to launch on one
  // stream (see grid_barrier and kLaneTag).
  unsigned* sync;
  int n_src, nseg, num_warps, width, q, q_tile, kd, flags, warps_per_block;
  // Rows [0, n_filled) each have a set slot: the one-lane class reads their
  // cols beside their extent.
  int n_filled;
  // The packed rows.
  int n_rows;
  // This launch's tag (the lane-vector grid: its all-active pass writes it
  // to sync[kLaneTag] when it sees an inactive source).
  unsigned tag;
};

// A grid-wide barrier (the launch is cooperative: every block resident).
// sync[0] counts arrivals and returns to 0 at each crossing; sync[1], the
// generation, only grows; sync[2 + parity] counts the blocks that saw an
// inactive source, and the crossing clears the next generation's entry.
// sync[kLaneTag]: the tag of the last lane-vector launch whose all-active
// pass saw an inactive source (tags only grow on a stream, so an older one
// never matches).
enum Sync { kArrivals = 0, kGeneration = 1, kInactive = 2, kLaneTag = 4 };

__device__ __forceinline__ unsigned volatile_load(const unsigned* p) {
  return *static_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void grid_barrier(unsigned* sync) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned g = volatile_load(sync + kGeneration);
    __threadfence();
    if (atomicAdd(sync + kArrivals, 1u) == gridDim.x - 1) {
      atomicExch(sync + kArrivals, 0u);
      atomicExch(sync + kInactive + ((g + 1) & 1), 0u);
      __threadfence();
      atomicAdd(sync + kGeneration, 1u);
    } else {
      while (volatile_load(sync + kGeneration) == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// The segment (first row, end row, lanes per row, first warp) of a warp of
// rows: the last whose first warp is <= warp, searched from segment lo.
__device__ __forceinline__ int find_segment(const Args& args, int warp,
                                            int lo) {
  int hi = args.nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(&args.segs[mid].w) <= warp) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// One warp's rows: G lanes per row (from the row's segment), 32 / G rows per
// warp, in one QT-wide query tile: lanes [q0, q0 + qn) of the message and
// output rows.  With all_active the sources' active flags are not read.
template <typename O, int R, typename P, int QT>
__device__ __forceinline__ void warp_rows(const Args& args, int warp,
                                          int tile, int4 seg,
                                          bool all_active) {
  using TM = typename O::M;
  using TE = typename O::E;
  using TD = typename O::D;
  using TA = typename O::A;
  constexpr int kSlotsPerLane = slots_per_lane<QT>();
  const int lanes = seg.z;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const long long row = seg.x +
                        static_cast<long long>(warp - seg.w) * (32 / lanes) +
                        lane / lanes;
  const bool live = row < seg.y;
  const int q = args.q;
  const int q0 = tile * args.q_tile;
  const int qn = min(args.q_tile, q - q0);
  const bool prefix = args.flags & kMaskIsPrefix;
  const bool vec_slots = args.flags & kVecSlots;
  const bool vec_msg = args.flags & kVecMsg;
  const TE* vals = static_cast<const TE*>(args.vals);
  const TM* msg = static_cast<const TM*>(args.msg);

  TA acc[QT];
  TD d[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    acc[j] = identity<TA, R>();
    d[j] = Num<TD>::zero();
  }
  if (P::kReadsDst && live) {
    // Once per row, not once per slot.
    const TD* dp = static_cast<const TD*>(args.dprop) + row * args.kd;
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      if (j < qn) d[j] = ro(dp + (args.kd == 1 ? 0 : q0 + j));
    }
  }

  bool got = false;
  const int end = live ? st(args.row_end + row) : 0;
  const long long base = row * args.width;
  for (int s0 = sub * kSlotsPerLane; s0 < end; s0 += lanes * kSlotsPerLane) {
    int c[kSlotsPerLane];
    TE e[kSlotsPerLane];
    bool ok[kSlotsPerLane];
    if (kSlotsPerLane % 4 == 0 && vec_slots) {
      // s0 + v is a multiple of 4 and s0 + v + 3 < width.
#pragma unroll
      for (int v = 0; v < kSlotsPerLane; v += 4) {
        uint8_t mk[4] = {1, 1, 1, 1};
        if (s0 + v < end) {
          ld4<true>(args.cols + base + s0 + v, c + v);
          if (P::kReadsEdge) ld4<true>(vals + base + s0 + v, e + v);
          if (!prefix) ld4<true>(args.mask + base + s0 + v, mk);
        } else {
          mk[0] = mk[1] = mk[2] = mk[3] = 0;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ok[v + i] = s0 + v + i < end && mk[i];
          if (!ok[v + i]) c[v + i] = 0;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kSlotsPerLane; ++i) {
        const bool in = s0 + i < end;
        c[i] = in ? st(args.cols + base + s0 + i) : 0;
        if (P::kReadsEdge) {
          e[i] = in ? st(vals + base + s0 + i) : Num<TE>::zero();
        }
        ok[i] = in && (prefix || st(args.mask + base + s0 + i));
      }
    }
    if (!P::kReadsEdge) {
#pragma unroll
      for (int i = 0; i < kSlotsPerLane; ++i) e[i] = Num<TE>::zero();
    }
    // The active flags of the lane's slots, then the message rows of the
    // active ones: each kind of load in flight together, and no message
    // read for an inactive source.
    uint8_t a[kSlotsPerLane];
    TM m[kSlotsPerLane][QT];
#pragma unroll
    for (int i = 0; i < kSlotsPerLane; ++i) {
      a[i] = ok[i] ? (all_active ? 1 : ro(args.active + c[i])) : 0;
    }
#pragma unroll
    for (int i = 0; i < kSlotsPerLane; ++i) {
      if (a[i]) {
        load_msg<TM, QT>(msg + static_cast<long long>(c[i]) * q + q0, qn,
                         vec_msg, m[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kSlotsPerLane; ++i) {
      if (a[i]) {
        got = true;
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          if (j < qn) {
            acc[j] = combine<TA, R>(
                acc[j], convert<TA>(P::apply(m[i][j], e[i], d[j])));
          }
        }
      }
    }
  }

  // The row's G lanes combine their accumulators (G is warp-uniform).
  for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      acc[j] = combine<TA, R>(acc[j], __shfl_xor_sync(kFull, acc[j], off));
    }
  }
  const unsigned ballot = __ballot_sync(kFull, got);
  const unsigned group =
      lanes == 32 ? kFull : ((1u << lanes) - 1u) << (lane & ~(lanes - 1));
  got = (ballot & group) != 0u;
  if (live) {
    typename O::R* out = static_cast<typename O::R*>(args.y) + row * q + q0;
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      if (j < qn && (j & (lanes - 1)) == sub) {
        out[j] = convert<typename O::R>(acc[j]);
      }
    }
    if (sub == 0 && tile == 0) args.recv[row] = got ? 1 : 0;
  }
}

// The one-lane class at a query tile of 1: a row of at most 4 slots to a
// lane, 32 consecutive packed rows to a warp, so the warp's 16-byte cols
// loads cover consecutive rows.  A row that has a set slot (row <
// n_filled) loads its cols beside its extent, not after it: the two loads
// are in flight together, and no slot is read that the 4-slot load of a
// non-empty row would not read.  Then the 4 slots' active flags, then the
// messages of the active sources and, unless every source is active, the
// edge values of rows with one (most rows have none on a thin frontier).
template <typename O, int R, typename P>
__device__ __forceinline__ void lane_row(const Args& args, int warp,
                                         int tile, int4 seg,
                                         bool all_active) {
  using TM = typename O::M;
  using TE = typename O::E;
  using TD = typename O::D;
  using TA = typename O::A;
  const long long row = seg.x +
                        static_cast<long long>(warp - seg.w) * 32 +
                        (threadIdx.x & 31);
  if (row >= seg.y) return;
  const int q = args.q;
  const bool vec = args.flags & kVecSlots;
  const TE* vals = static_cast<const TE*>(args.vals);
  const TM* msg = static_cast<const TM*>(args.msg);
  const long long base = row * args.width;
  TD d = Num<TD>::zero();
  if (P::kReadsDst) {
    d = ro(static_cast<const TD*>(args.dprop) + row * args.kd +
           (args.kd == 1 ? 0 : tile));
  }
  int c[4] = {0, 0, 0, 0};
  TE e[4];
  uint8_t mk[4] = {1, 1, 1, 1};
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = Num<TE>::zero();
  int end;
  if (vec && row < args.n_filled) {
    ld4<true>(args.cols + base, c);
    if (P::kReadsEdge && all_active) ld4<true>(vals + base, e);
    end = st(args.row_end + row);
  } else {
    end = st(args.row_end + row);
    if (vec) {
      if (end > 0) {
        ld4<true>(args.cols + base, c);
        if (P::kReadsEdge && all_active) ld4<true>(vals + base, e);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < end) {
          c[i] = st(args.cols + base + i);
          if (P::kReadsEdge && all_active) e[i] = st(vals + base + i);
        }
      }
    }
  }
  if (!(args.flags & kMaskIsPrefix) && end > 0) {
    if (vec) {
      ld4<true>(args.mask + base, mk);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < end) mk[i] = st(args.mask + base + i);
      }
    }
  }
  uint8_t a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = (i < end && mk[i]) ? (all_active ? 1 : ro(args.active + c[i])) : 0;
  }
  TM m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = a[i] ? ro(msg + static_cast<long long>(c[i]) * q + tile)
                : Num<TM>::zero();
  }
  if (P::kReadsEdge && !all_active && (a[0] | a[1] | a[2] | a[3])) {
    if (vec) {
      ld4<true>(vals + base, e);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (a[i]) e[i] = st(vals + base + i);
      }
    }
  }
  TA acc = identity<TA, R>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (a[i]) acc = combine<TA, R>(acc, convert<TA>(P::apply(m[i], e[i], d)));
  }
  static_cast<typename O::R*>(args.y)[row * q + tile] =
      convert<typename O::R>(acc);
  if (tile == 0) args.recv[row] = (a[0] | a[1] | a[2] | a[3]) ? 1 : 0;
}

// COOP: a cooperative launch of as many blocks as fit on the card; the
// blocks first find whether every source is active (then no slot reads an
// active flag) and cross a grid barrier.  Else a plain launch of a warp for
// each warp of rows, for tables whose rows are all in the one-lane class.
// Then the grid's warps walk the warps of rows in turn, one query tile
// after another.
// Whether this block sees an inactive source (`first` and `threads`: this
// thread's place in the grid and the grid's size), on every thread of it.
__device__ __forceinline__ bool block_sees_inactive(const Args& args,
                                                    long long first,
                                                    long long threads) {
  bool inactive = false;
  long long done = 0;
  if (args.flags & kVecActive) {  // 16 flags a load
    const uint4* a16 = reinterpret_cast<const uint4*>(args.active);
    done = args.n_src / 16 * 16;
    for (long long v = first; v < args.n_src / 16; v += threads) {
      const uint4 w = __ldcs(a16 + v);
      inactive |= (w.x & w.y & w.z & w.w) != 0x01010101u;
    }
  }
  for (long long v = done + first; v < args.n_src; v += threads) {
    inactive |= !ro(args.active + v);
  }
  return __syncthreads_or(inactive);
}

// A cooperative launch's prologue: whether every source is active, found
// by the whole grid (the blocks that see an inactive one count themselves
// in this generation's entry of the sync words) and agreed on across a
// grid barrier.
__device__ __forceinline__ bool all_sources_active(const Args& args,
                                                   long long first,
                                                   long long threads) {
  const unsigned gen = volatile_load(args.sync + kGeneration);
  if (block_sees_inactive(args, first, threads) && threadIdx.x == 0) {
    atomicAdd(args.sync + kInactive + (gen & 1), 1u);
  }
  grid_barrier(args.sync);
  return volatile_load(args.sync + kInactive + (gen & 1)) == 0u;
}

template <typename O, int R, typename P, int QT, bool COOP>
__global__ void ell_spmv_kernel(const Args args) {
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const bool all_active = COOP && all_sources_active(args, first, threads);
  const int tiles = (args.q + args.q_tile - 1) / args.q_tile;
  const int warps = static_cast<int>(threads >> 5);
  for (int tile = 0; tile < tiles; ++tile) {
    int lo = 0;
    int4 seg = make_int4(0, 0, 0, -1);
    for (int warp = static_cast<int>(first >> 5); warp < args.num_warps;
         warp += warps) {
      // A warp's rows only move forward: advance the segment rather than
      // search again.
      if (seg.w < 0 ||
          (lo + 1 < args.nseg && __ldg(&args.segs[lo + 1].w) <= warp)) {
        lo = find_segment(args, warp, lo);
        seg = __ldg(args.segs + lo);
      }
      if (QT == 1 && seg.z == 1) {
        lane_row<O, R, P>(args, warp, tile, seg, all_active);
      } else {
        warp_rows<O, R, P, QT>(args, warp, tile, seg, all_active);
      }
    }
  }
}

template <typename O, int R, typename P, int QT>
cudaError_t launch_coop(const Args& a, cudaStream_t stream) {
  // As many blocks as can be resident at once (a cooperative launch
  // refuses more), and no more than the rows need.  The card's size and
  // the kernel's occupancy are asked once per device and block size.
  const auto kernel = ell_spmv_kernel<O, R, P, QT, true>;
  const dim3 block(32 * a.warps_per_block);
  static int cached_dev = -1, cached_threads = 0, resident = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != cached_dev || static_cast<int>(block.x) != cached_threads) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block.x, 0);
    cached_dev = dev;
    cached_threads = block.x;
    resident = sms * per_sm;
  }
  const int needed = (a.num_warps + a.warps_per_block - 1) /
                     a.warps_per_block;
  const int blocks = needed < resident ? needed
                     : (resident > 0 ? resident : 1);
  Args copy = a;
  void* params[] = {&copy};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(blocks), block, params, 0, stream);
}

template <typename O, int R, typename P>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.q_tile != 1) return launch_coop<O, R, P, 8>(a, stream);
  if (!(a.flags & kShortRows)) return launch_coop<O, R, P, 1>(a, stream);
  // Every row of at most 4 slots: a plain launch, a warp for each 32 rows.
  const int needed = (a.num_warps + a.warps_per_block - 1) /
                     a.warps_per_block;
  ell_spmv_kernel<O, R, P, 1, false>
      <<<needed, 32 * a.warps_per_block, 0, stream>>>(a);
  return cudaSuccess;
}

// B bytes (one value or a vector of them) of a message row, through the
// read-only path.
template <int B>
struct Bytes;
template <>
struct Bytes<16> { using type = uint4; };
template <>
struct Bytes<8> { using type = uint2; };
template <>
struct Bytes<4> { using type = unsigned; };
template <>
struct Bytes<2> { using type = unsigned short; };
template <>
struct Bytes<1> { using type = unsigned char; };

template <int B>
__device__ __forceinline__ typename Bytes<B>::type ld_msg(const void* p) {
  return __ldg(reinterpret_cast<const typename Bytes<B>::type*>(p));
}

// Thread `sub`'s V lanes (sub * V + j) of message row c, W at a time where
// `vec` (the message pointer is aligned to W values; every row then is,
// since W divides K), else one at a time; zero for c < 0 and for lanes at
// or past K.
template <typename TM, int K, int V, int W>
__device__ __forceinline__ void load_lanes(const TM* msg, int c, int sub,
                                           bool vec, TM (&m)[V]) {
#pragma unroll
  for (int j = 0; j < V; j += W) {
    const int k = sub * V + j;
    if (c >= 0 && k < K) {
      const TM* p = msg + static_cast<long long>(c) * K + k;
      if (W > 1 && vec) {
        const auto w = ld_msg<W * sizeof(TM)>(p);
        memcpy(m + j, &w, sizeof(w));
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const auto w = ld_msg<sizeof(TM)>(p + i);
          memcpy(m + j + i, &w, sizeof(TM));
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) m[j + i] = Num<TM>::zero();
    }
  }
}

// The lane-vector grid's blocks: at most kLanesThreads threads, with
// registers for kLanesBlocks of them on an SM (40 a thread: its loads wait
// on gathers, so the warps in flight set its pace).
constexpr int kLanesThreads = 256, kLanesBlocks = 6;

// One warp of rows of the lane-vector grid, for a process P that mixes the
// lanes of a K-lane message (segment `seg` of the row-class table).  A team
// of T = P::kTeam threads holds one message, V = P::kVec contiguous lanes a
// thread; a warp has 32 / T teams.  A packed row gets G threads (a power
// of two from T to 32: G / T teams, the fewest whose steps of U =
// P::kSlots slots a team cover the row, capped at the warp), and a warp
// serves 32 / G rows.  A step of a row takes its next (G / T) * U slots:
// the row's G threads load their cols (and vals, and the mask where it is
// read) one slot a thread, consecutive, evict-first, then (unless every
// source is active) the active flag of the col each holds; shuffles hand
// slot u * (G / T) + t of the step to team t, whose threads then load
// their lanes of the U messages (at most 16 bytes a load, all U in flight)
// and apply P to each, every thread of the warp together.  The teams of a
// row keep their own accumulators (K_out of them spread over the team) and
// combine them once, at the row's end, by a butterfly over the row's
// threads: float sums in float in that fixed order, min and max exactly.
template <typename O, int R, typename P>
__device__ __forceinline__ void lane_rows(const Args& args, int warp,
                                          int4 seg, bool all_active) {
  using TM = typename O::M;
  using TE = typename O::E;
  using TD = typename O::D;
  using TA = typename O::A;
  using TR = typename O::R;
  constexpr int K = P::kLanes;
  constexpr int T = P::kTeam;
  constexpr int V = P::kVec;
  constexpr int W = P::kLoad;
  constexpr int U = P::kSlots;
  constexpr int OV = P::kOut == 1 ? 1 : V;
  constexpr int DV = P::kDstLanes == 1 ? 1 : V;
  // Cols loads a thread per step: a row's G >= T threads load U * G / T
  // slots.
  constexpr int ROUNDS = (U + T - 1) / T;
  const int lane = threadIdx.x & 31;
  const int g = seg.z;
  const int teams = g / T;
  const int in_row = lane & (g - 1);
  const int team = in_row / T;
  const int sub = in_row & (T - 1);
  const long long row = seg.x +
                        static_cast<long long>(warp - seg.w) * (32 / g) +
                        lane / g;
  const bool live = row < seg.y;
  const int end = live ? st(args.row_end + row) : 0;
  // The warp steps together (the functor's shuffles name it all) to its
  // longest row's end.
  const int warp_end = __reduce_max_sync(kFull, end);
  const bool prefix = args.flags & kMaskIsPrefix;
  const bool vec = args.flags & kVecMsg;
  const TE* vals = static_cast<const TE*>(args.vals);
  const TM* msg = static_cast<const TM*>(args.msg);
  TD d[DV];
#pragma unroll
  for (int j = 0; j < DV; ++j) {
    const int k = P::kDstLanes == 1 ? 0 : sub * V + j;
    d[j] = (P::kReadsDst && live && k < K)
               ? st(static_cast<const TD*>(args.dprop) + row * args.kd + k)
               : Num<TD>::zero();
  }
  TA acc[OV];
#pragma unroll
  for (int j = 0; j < OV; ++j) acc[j] = identity<TA, R>();
  bool got = false;
  const long long base = row * args.width;
  const int step = U * teams;
  for (int s0 = 0; s0 < warp_end; s0 += step) {
    // This thread's slots of the step: col, or -1 for a slot that is past
    // the row, masked off or from an inactive source.
    int c[ROUNDS];
    TE e[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int i = r * g + in_row;
      const int s = s0 + i;
      c[r] = -1;
      e[r] = Num<TE>::zero();
      if ((ROUNDS * T == U || i < step) && s < end) {
        c[r] = st(args.cols + base + s);
        if (P::kReadsEdge) e[r] = st(vals + base + s);
        if (!prefix && !st(args.mask + base + s)) c[r] = -1;
      }
    }
    if (!all_active) {
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r) {
        if (c[r] >= 0 && !ro(args.active + c[r])) c[r] = -1;
      }
    }
    // Slot u * teams + team of the step: held by thread (u % T) * teams +
    // team of the row in round u / T.
    int cu[U];
    TE eu[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int src = (u % T) * teams + team;
      cu[u] = shfl(c[u / T], src, g);
      eu[u] = P::kReadsEdge ? shfl(e[u / T], src, g) : Num<TE>::zero();
    }
    TM m[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      load_lanes<TM, K, V, W>(msg, cu[u], sub, vec, m[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      TR r[OV];
      P::apply(m[u], eu[u], d, r, sub);
      if (cu[u] >= 0) {  // the same on every thread of the team
        got = true;
#pragma unroll
        for (int j = 0; j < OV; ++j) {
          acc[j] = combine<TA, R>(acc[j], convert<TA>(r[j]));
        }
      }
    }
  }
  // The row's teams combine (G is warp-uniform).
  for (int off = T; off < g; off <<= 1) {
#pragma unroll
    for (int j = 0; j < OV; ++j) {
      acc[j] = combine<TA, R>(acc[j], shfl_xor(acc[j], off, 32));
    }
  }
  const unsigned ballot = __ballot_sync(kFull, got);
  const unsigned rows = g == 32 ? kFull : ((1u << g) - 1u) << (lane & ~(g - 1));
  got = (ballot & rows) != 0u;
  if (!live) return;
  TR* y = static_cast<TR*>(args.y);
  if (P::kOut == 1) {
    if (in_row == 0) y[row] = convert<TR>(acc[0]);
  } else if (team == 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int k = sub * V + j;
      if (k < K) y[row * K + k] = convert<TR>(acc[j]);
    }
  }
  if (in_row == 0) args.recv[row] = got ? 1 : 0;
}

// The lane-vector grid's all-active pass, a plain launch just before
// lanes_kernel on the same stream: a block that sees an inactive source
// writes the launch's tag to sync[kLaneTag].
__global__ void active_pass(const Args args) {
  if (block_sees_inactive(
          args, static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
          static_cast<long long>(gridDim.x) * blockDim.x) &&
      threadIdx.x == 0) {
    *static_cast<volatile unsigned*>(args.sync + kLaneTag) = args.tag;
  }
}

// The lane-vector grid: a warp for each warp of rows of the row-class
// table (segs: first row, end row, G, first warp; made once per graph and
// (T, U) by the wrapper).  Every source is active when active_pass did not
// write this launch's tag (then no slot reads a flag, which takes a
// dependent load off each step).
template <typename O, int R, typename P>
__global__ void __launch_bounds__(kLanesThreads, kLanesBlocks)
    lanes_kernel(const Args args) {
  const int warp = static_cast<int>(
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  if (warp >= args.num_warps) return;  // the whole warp
  lane_rows<O, R, P>(args, warp,
                     __ldg(args.segs + find_segment(args, warp, 0)),
                     volatile_load(args.sync + kLaneTag) != args.tag);
}

// Validates the arguments, makes the stream's device current, launches on
// `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).  Any error
// left pending by earlier work is cleared first, so the code returned
// belongs to this launch.  LANES: the lane-vector grid (its all-active
// pass, then a plain launch over its row-class table, segs), for a
// lane-mixing P.
template <typename O, int R, typename P, bool LANES = false>
int run_ell(const void* cols, const void* vals, const void* mask,
            const void* msg, const void* active, const void* dprop,
            const void* row_end, const void* segs, void* y, void* recv,
            void* sync, int n_src, int nseg, int num_warps, int width, int q,
            int q_tile, int kd, int flags, int warps_per_block, int n_filled,
            int n_rows, int tag, int device, void* stream) {
  bool bad;
  if constexpr (LANES) {
    bad = sync == nullptr || n_src < 1 || n_rows < 1 || nseg < 1 ||
          num_warps < 1 || width < 1 || q != P::kLanes ||
          warps_per_block < 1 || warps_per_block > 32 ||
          (P::kReadsDst && (dprop == nullptr || kd != P::kDstLanes));
  } else {
    bad = sync == nullptr || n_src < 1 || nseg < 1 || num_warps < 1 ||
          width < 1 || q < 1 || q_tile < 1 || q_tile > 8 ||
          warps_per_block < 1 || warps_per_block > 32 || n_filled < 0 ||
          (P::kReadsDst && (dprop == nullptr || (kd != 1 && kd != q)));
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  // The launch goes to the stream's device, made current for it.
  int current = 0;
  if (cudaGetDevice(&current) != cudaSuccess) {
    return static_cast<int>(cudaGetLastError());
  }
  if (current != device && cudaSetDevice(device) != cudaSuccess) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaGetLastError();
  const Args a{static_cast<const int*>(cols), vals,
               static_cast<const uint8_t*>(mask), msg,
               static_cast<const uint8_t*>(active), dprop,
               static_cast<const int*>(row_end),
               static_cast<const int4*>(segs), y, static_cast<int8_t*>(recv),
               static_cast<unsigned*>(sync), n_src, nseg, num_warps, width,
               q, q_tile, kd, flags, warps_per_block, n_filled, n_rows,
               static_cast<unsigned>(tag)};
  cudaError_t err = cudaSuccess;
  if constexpr (LANES) {
    // The all-active pass (16 flags a thread, up to 1,024 blocks), then a
    // warp for each warp of rows of the table, at most kLanesThreads / 32
    // warps a block.
    const long long pass =
        (static_cast<long long>(n_src) + 16 * 256 - 1) / (16 * 256);
    active_pass<<<static_cast<int>(pass < 1024 ? pass : 1024), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
    const int wpb = warps_per_block < kLanesThreads / 32
                        ? warps_per_block : kLanesThreads / 32;
    lanes_kernel<O, R, P><<<(num_warps + wpb - 1) / wpb, 32 * wpb, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  } else {
    err = launch<O, R, P>(a, static_cast<cudaStream_t>(stream));
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // namespace
