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
// [n_pad, Kd], Kd = 1 or Q, already in packed-row order).  Types: float,
// half, int32; the sum is kept in the output type, as the TPU kernel keeps
// it; float arithmetic is rounded op by op (no contraction into FMAs), as
// the plain version rounds it.
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

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_process.cuh"

namespace {

enum Reduce { kAdd = 0, kMin = 1, kMax = 2 };
enum DType { kF32 = 0, kF16 = 1, kI32 = 2 };
// Launch flags: the mask is a prefix of every row (do not read it); cols,
// vals and mask rows allow 4-slot vector loads; message rows allow 4-value
// vector loads; active allows 16-flag vector loads; every row is in the
// one-lane class (a plain launch sized to the rows, no all-active pass).
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
  // The cooperative launch's barrier and all-active flag, 4 words that
  // carry over from launch to launch on one stream (see grid_barrier).
  unsigned* sync;
  int n_src, nseg, num_warps, width, q, q_tile, kd, flags, warps_per_block;
  // Rows [0, n_filled) each have a set slot: the one-lane class reads their
  // cols beside their extent.
  int n_filled;
};

// A grid-wide barrier (the launch is cooperative: every block resident).
// sync[0] counts arrivals and returns to 0 at each crossing; sync[1], the
// generation, only grows; sync[2 + parity] counts the blocks that saw an
// inactive source, and the crossing clears the next generation's entry.
enum Sync { kArrivals = 0, kGeneration = 1, kInactive = 2 };

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
template <typename T, int R, typename P, int QT>
__device__ __forceinline__ void warp_rows(const Args& args, int warp,
                                          int tile, int4 seg,
                                          bool all_active) {
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
  const T* vals = static_cast<const T*>(args.vals);
  const T* msg = static_cast<const T*>(args.msg);

  T acc[QT];
  T d[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    acc[j] = identity<T, R>();
    d[j] = Num<T>::zero();
  }
  if (P::kReadsDst && live) {
    // Once per row, not once per slot.
    const T* dp = static_cast<const T*>(args.dprop) + row * args.kd;
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
    T e[kSlotsPerLane];
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
          e[i] = in ? st(vals + base + s0 + i) : Num<T>::zero();
        }
        ok[i] = in && (prefix || st(args.mask + base + s0 + i));
      }
    }
    if (!P::kReadsEdge) {
#pragma unroll
      for (int i = 0; i < kSlotsPerLane; ++i) e[i] = Num<T>::zero();
    }
    // The active flags of the lane's slots, then the message rows of the
    // active ones: each kind of load in flight together, and no message
    // read for an inactive source.
    uint8_t a[kSlotsPerLane];
    T m[kSlotsPerLane][QT];
#pragma unroll
    for (int i = 0; i < kSlotsPerLane; ++i) {
      a[i] = ok[i] ? (all_active ? 1 : ro(args.active + c[i])) : 0;
    }
#pragma unroll
    for (int i = 0; i < kSlotsPerLane; ++i) {
      if (a[i]) {
        load_msg<T, QT>(msg + static_cast<long long>(c[i]) * q + q0, qn,
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
            acc[j] = combine<T, R>(acc[j], P::apply(m[i][j], e[i], d[j]));
          }
        }
      }
    }
  }

  // The row's G lanes combine their accumulators (G is warp-uniform).
  for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      acc[j] = combine<T, R>(acc[j], __shfl_xor_sync(kFull, acc[j], off));
    }
  }
  const unsigned ballot = __ballot_sync(kFull, got);
  const unsigned group =
      lanes == 32 ? kFull : ((1u << lanes) - 1u) << (lane & ~(lanes - 1));
  got = (ballot & group) != 0u;
  if (live) {
    T* out = static_cast<T*>(args.y) + row * q + q0;
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      if (j < qn && (j & (lanes - 1)) == sub) out[j] = acc[j];
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
template <typename T, int R, typename P>
__device__ __forceinline__ void lane_row(const Args& args, int warp,
                                         int tile, int4 seg,
                                         bool all_active) {
  const long long row = seg.x +
                        static_cast<long long>(warp - seg.w) * 32 +
                        (threadIdx.x & 31);
  if (row >= seg.y) return;
  const int q = args.q;
  const bool vec = args.flags & kVecSlots;
  const T* vals = static_cast<const T*>(args.vals);
  const T* msg = static_cast<const T*>(args.msg);
  const long long base = row * args.width;
  T d = Num<T>::zero();
  if (P::kReadsDst) {
    d = ro(static_cast<const T*>(args.dprop) + row * args.kd +
           (args.kd == 1 ? 0 : tile));
  }
  int c[4] = {0, 0, 0, 0};
  T e[4];
  uint8_t mk[4] = {1, 1, 1, 1};
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = Num<T>::zero();
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
  T m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = a[i] ? ro(msg + static_cast<long long>(c[i]) * q + tile)
                : Num<T>::zero();
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
  T acc = identity<T, R>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (a[i]) acc = combine<T, R>(acc, P::apply(m[i], e[i], d));
  }
  static_cast<T*>(args.y)[row * q + tile] = acc;
  if (tile == 0) args.recv[row] = (a[0] | a[1] | a[2] | a[3]) ? 1 : 0;
}

// COOP: a cooperative launch of as many blocks as fit on the card; the
// blocks first find whether every source is active (then no slot reads an
// active flag) and cross a grid barrier.  Else a plain launch of a warp for
// each warp of rows, for tables whose rows are all in the one-lane class.
// Then the grid's warps walk the warps of rows in turn, one query tile
// after another.
template <typename T, int R, typename P, int QT, bool COOP>
__global__ void ell_spmv_kernel(const Args args) {
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  bool all_active = false;
  if (COOP) {
    const unsigned gen = volatile_load(args.sync + kGeneration);
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
    if (__syncthreads_or(inactive) && threadIdx.x == 0) {
      atomicAdd(args.sync + kInactive + (gen & 1), 1u);
    }
    grid_barrier(args.sync);
    all_active = volatile_load(args.sync + kInactive + (gen & 1)) == 0u;
  }
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
        lane_row<T, R, P>(args, warp, tile, seg, all_active);
      } else {
        warp_rows<T, R, P, QT>(args, warp, tile, seg, all_active);
      }
    }
  }
}

template <typename T, int R, typename P, int QT>
cudaError_t launch_coop(const Args& a, cudaStream_t stream) {
  // As many blocks as can be resident at once (a cooperative launch
  // refuses more), and no more than the rows need.  The card's size and
  // the kernel's occupancy are asked once per device and block size.
  const auto kernel = ell_spmv_kernel<T, R, P, QT, true>;
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

template <typename T, int R, typename P>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.q_tile != 1) return launch_coop<T, R, P, 8>(a, stream);
  if (!(a.flags & kShortRows)) return launch_coop<T, R, P, 1>(a, stream);
  // Every row of at most 4 slots: a plain launch, a warp for each 32 rows.
  const int needed = (a.num_warps + a.warps_per_block - 1) /
                     a.warps_per_block;
  ell_spmv_kernel<T, R, P, 1, false>
      <<<needed, 32 * a.warps_per_block, 0, stream>>>(a);
  return cudaSuccess;
}

// Validates the arguments, makes the stream's device current, launches on
// `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).  Any error
// left pending by earlier work is cleared first, so the code returned
// belongs to this launch.
template <typename T, int R, typename P>
int run_ell(const void* cols, const void* vals, const void* mask,
            const void* msg, const void* active, const void* dprop,
            const void* row_end, const void* segs, void* y, void* recv,
            void* sync, int n_src, int nseg, int num_warps, int width, int q,
            int q_tile, int kd, int flags, int warps_per_block, int n_filled,
            int device, void* stream) {
  if (sync == nullptr || n_src < 1 || nseg < 1 || num_warps < 1 ||
      width < 1 || q < 1 || q_tile < 1 || q_tile > 8 ||
      warps_per_block < 1 || warps_per_block > 32 || n_filled < 0 ||
      (P::kReadsDst && (dprop == nullptr || (kd != 1 && kd != q)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
               q, q_tile, kd, flags, warps_per_block, n_filled};
  cudaError_t err = launch<T, R, P>(a, static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // namespace
