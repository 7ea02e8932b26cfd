// Generalized COO SpMV for Hopper (sm_90a): a segmented gather-process-
// reduce over destination-sorted edges, templated on the per-edge process
// (included by coo_spmv.cu and by the sources generated for traced
// processes).
//
// It replaces no Pallas kernel: the reference leaves its COO paths
// (src/repro/core/spmv.py::spmv_coo, spmv_coo_tiled and the ELL spill
// merge) to XLA's gathers and scatters.  On the card the port ran them as
// PyTorch's gather, the process over [E, ...] tensors written out in full,
// scatter_reduce_ and index_add_ for recv: 88% of the graph cells' device
// time (the spill merge) and 94% of a collaborative-filtering sweep (phase
// V).  For every run of edges with equal dst v (the edge list is sorted by
// dst) and lane q:
//
//   y[v, q] = REDUCE_e { process(msg[src[e], q], w[e], dprop[v, q])
//                        : emask[e] && active[src[e]] }
//   recv[v] = any_e (emask[e] && active[src[e]])
//
// REDUCE is add, min or max, as in ell_spmv_body.cuh, and the process is
// the same functor P the ELL kernel runs (a shipped form of ell_process.cuh
// or a traced process_message over Operands<M, E, D, R, A>), lanewise on a
// [n, Q] message (one thread an edge, a query tile of up to 8 lanes) or
// mixing the lanes of a [n, K] message (a team of P::kTeam threads an edge,
// P::kVec lanes a thread).  A run's y and recv are written once, and only
// for a run with a valid edge; the wrapper fills y with the identity and
// recv with 0 first, or (kCooMerge) y and recv hold the ELL rows' result
// and the run folds into it: y[v] = recv[v] ? REDUCE(y[v], r) : r, recv[v]
// = 1, as merge_spill does.  Half and bfloat16 results sum in float (A)
// and round once.
//
// What bounds it: bytes, counted as the work needs them.  Per edge 4 bytes
// of src (an int32 copy, -1 where emask is false) and, for a process that
// reads it, the edge value; each source's message and active flag, each
// destination's property and result once.  The random message gathers go
// through L1 and L2 and are not counted, as for the ELL rows; their floor
// (the same gathers with nothing else, tools/gather_floor.cu) is logged
// beside the bound.
//
// Design, sized for hub runs (a spilled hub's thousands of edges, a
// popular item's hundreds of thousands of ratings):
// * Equal tiles of tile_edges edges, a warp each, whatever the runs'
//   lengths: an edge-balanced grid needs no parameter for a spill's few
//   long runs, CF's Zipf runs or a 2-D block's many short ones.
// * A warp steps through its tile 32 / T edges at a time.  A bitmap made
//   once per graph marks each run's first edge (heads), so a step reads
//   one word of it and no dst; a run's dst and dprop are read at its head
//   (and at the tile's first edge) and handed to the other teams by
//   shuffles: once per run, not once per edge.
// * In a step with no head, each team adds its edge to its own share of
//   the open run.  At a head, the open run closes: its teams' shares
//   combine by a butterfly; the runs that begin in the step combine by a
//   segmented scan over the teams; the last stays open.  Every combine is
//   in an order fixed by the tile's layout, so add sums are the same from
//   run to run, and no atomics are used.
// * A run that lies wholly in its tile is written by the warp.  A run that
//   crosses a tile boundary leaves its tile's share in a carry array (slot
//   0: the run holding the tile's first edge; slot 1: the run that goes on
//   past the tile's end), and a second, short pass (coo_gather_carry_kernel,
//   a warp a split run, from the per-graph table of split runs) combines
//   the carries in tile order.
// * A warp loads U steps at a time (32 bytes of messages a thread, or the
//   process's kSlots): their active flags, then their messages, each kind
//   of load in flight together, while the next U steps' src and edge
//   values load.  A pass before it finds whether every source is active;
//   then no edge reads an active flag.
// Measured (H100 80GB HBM3, 700 W; the card's time a call,
// tools/time_coo_kernel.py): Graph500-s20's spill of 16.9 M edges 0.139-
// 0.144 ms at Q = 1 (bound 0.041, gather floor 0.122; PyTorch's gather and
// scatter 1.45-1.57 ms), 0.25-0.27 ms at Q = 8 (PyTorch 14.4-15.1), PageRank's
// add 0.134 ms (torch.sparse.mm 0.155); CF's phase V over the Netflix
// Prize's 100.5 M ratings at K = 16 2.16 ms (bound 0.25, gather floor
// 0.97-1.50; PyTorch 284 ms).

#pragma once

#include "ell_spmv_body.cuh"

namespace {

// kCooMerge: y and recv hold a result to fold the runs into.  kCooVecMsg:
// message rows allow vector loads (lanewise: 4 values; lane-mixing:
// P::kLoad values).  kCooVecActive: active allows 16-flag loads.
enum CooFlags { kCooMerge = 1, kCooVecMsg = 2, kCooVecActive = 4 };

struct CooArgs {
  const int* src;          // int32[cap]: source, -1 where emask is false
  const void* w;           // [cap] edge values
  const unsigned* heads;   // bit e % 32 of word e / 32: edge e begins a run
  const long long* dst;    // int64[cap], non-decreasing
  const void* msg;         // [n_src, q]
  const uint8_t* active;   // [n_src]
  const void* dprop;       // [n_dst, kd], where the process reads it
  const int4* splits;      // (first tile, last tile, first slot, dst)
  void* y;                 // [n_dst, k_out]
  uint8_t* recv;           // [n_dst], or null
  void* carry;             // A[num_tiles, 2, k_out]
  uint8_t* carry_got;      // [num_tiles, 2]
  // A word the frontier pass sets to `tag` when it sees an inactive source
  // (tags only grow on a stream, so an older launch's never matches).
  unsigned* frontier;
  long long cap, n_src;
  int tile_edges, num_tiles, num_splits;
  int q, q_tile, kd, k_out, flags;
  unsigned tag;
};

__device__ __forceinline__ bool head_bit(const CooArgs& a, long long e) {
  return (__ldg(a.heads + (e >> 5)) >> (e & 31)) & 1u;
}

// A lanewise process on a [n, q] message: one thread an edge, lanes
// [q0, q0 + qn) of a query tile of at most QT.  U steps' gathers are in
// flight together (a single query's four).  (Two threads an edge at QT = 8,
// 4 lanes each, ran the SSSP spill at a 10% frontier 11% slower on an H100.)
template <typename O, typename P, int QT>
struct Lanewise {
  using TM = typename O::M;
  using TE = typename O::E;
  using TD = typename O::D;
  using TR = typename O::R;
  static constexpr int T = 1, V = QT, OV = QT, DV = QT;
  static constexpr int U =
      32 / (V * static_cast<int>(sizeof(TM))) >= 4
          ? 4
          : (32 / (V * static_cast<int>(sizeof(TM))) >= 2 ? 2 : 1);
  static constexpr bool kReadsEdge = P::kReadsEdge;
  static constexpr bool kReadsDst = P::kReadsDst;

  __device__ __forceinline__ static void gather(const CooArgs& a, int c,
                                                int, int q0, int qn,
                                                TM (&m)[V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) m[j] = Num<TM>::zero();
    if (c >= 0) {
      load_msg<TM, QT>(static_cast<const TM*>(a.msg) +
                           static_cast<long long>(c) * a.q + q0,
                       qn, a.flags & kCooVecMsg, m);
    }
  }
  __device__ __forceinline__ static void property(const CooArgs& a,
                                                  long long v, int, int q0,
                                                  int qn, TD (&d)[DV]) {
    const TD* p = static_cast<const TD*>(a.dprop) + v * a.kd;
#pragma unroll
    for (int j = 0; j < DV; ++j) {
      d[j] = j < qn ? ro(p + (a.kd == 1 ? 0 : q0 + j)) : Num<TD>::zero();
    }
  }
  __device__ __forceinline__ static void apply(const TM (&m)[V], TE e,
                                               const TD (&d)[DV],
                                               TR (&r)[OV], int) {
#pragma unroll
    for (int j = 0; j < V; ++j) r[j] = P::apply(m[j], e, d[j]);
  }
  // The output lane of this thread's value j, or -1.
  __device__ __forceinline__ static int out_lane(int, int j, int q0,
                                                 int qn) {
    return j < qn ? q0 + j : -1;
  }
};

// A process that mixes the lanes of a [n, K] message: a team of P::kTeam
// threads an edge, P::kVec contiguous lanes a thread (ell_process.cuh).
template <typename O, typename P>
struct Mixing {
  using TM = typename O::M;
  using TE = typename O::E;
  using TD = typename O::D;
  using TR = typename O::R;
  static constexpr int K = P::kLanes;
  static constexpr int T = P::kTeam, V = P::kVec;
  static constexpr int OV = P::kOut == 1 ? 1 : P::kVec;
  static constexpr int DV = P::kDstLanes == 1 ? 1 : P::kVec;
  static constexpr int U = P::kSlots;
  static constexpr bool kReadsEdge = P::kReadsEdge;
  static constexpr bool kReadsDst = P::kReadsDst;

  __device__ __forceinline__ static void gather(const CooArgs& a, int c,
                                                int sub, int, int,
                                                TM (&m)[V]) {
    load_lanes<TM, K, V, P::kLoad>(static_cast<const TM*>(a.msg), c, sub,
                                   a.flags & kCooVecMsg, m);
  }
  __device__ __forceinline__ static void property(const CooArgs& a,
                                                  long long v, int sub, int,
                                                  int, TD (&d)[DV]) {
    const TD* p = static_cast<const TD*>(a.dprop) + v * a.kd;
#pragma unroll
    for (int j = 0; j < DV; ++j) {
      const int k = P::kDstLanes == 1 ? 0 : sub * V + j;
      d[j] = k < K ? ro(p + k) : Num<TD>::zero();
    }
  }
  __device__ __forceinline__ static void apply(const TM (&m)[V], TE e,
                                               const TD (&d)[DV],
                                               TR (&r)[OV], int sub) {
    P::apply(m, e, d, r, sub);
  }
  __device__ __forceinline__ static int out_lane(int sub, int j, int, int) {
    if (P::kOut == 1) return sub == 0 && j == 0 ? 0 : -1;
    const int k = sub * V + j;
    return k < K ? k : -1;
  }
};

// One run's share (or whole) from this thread's lanes: written to y and
// recv when the run lies wholly in the tile [lo, hi) (it begins at or
// after lo and its next edge begins a run or ends the list), else to the
// tile's carry slot (0 for the run that holds the tile's first edge, 1 for
// the one that goes on past its end).  Called by the threads of one team.
template <typename O, int R, typename L>
__device__ __forceinline__ void flush(const CooArgs& a,
                                      const typename O::A (&acc)[L::OV],
                                      bool got, long long start,
                                      long long last, long long v, int tile,
                                      long long lo, int sub, int q0, int qn,
                                      bool first_q) {
  using TA = typename O::A;
  using TR = typename O::R;
  const bool whole =
      start >= lo && (last + 1 == a.cap || head_bit(a, last + 1));
  if (whole) {
    if (!got) return;
    const bool prior = (a.flags & kCooMerge) && a.recv[v];
    TR* y = static_cast<TR*>(a.y) + v * a.k_out;
#pragma unroll
    for (int j = 0; j < L::OV; ++j) {
      const int k = L::out_lane(sub, j, q0, qn);
      if (k >= 0) {
        const TR r = convert<TR>(acc[j]);
        y[k] = prior ? combine<TR, R>(y[k], r) : r;
      }
    }
    if (first_q && sub == 0 && a.recv != nullptr) a.recv[v] = 1;
    return;
  }
  const long long slot =
      static_cast<long long>(tile) * 2 + (start <= lo ? 0 : 1);
  TA* carry = static_cast<TA*>(a.carry) + slot * a.k_out;
#pragma unroll
  for (int j = 0; j < L::OV; ++j) {
    const int k = L::out_lane(sub, j, q0, qn);
    if (k >= 0) carry[k] = acc[j];
  }
  if (first_q && sub == 0) a.carry_got[slot] = got ? 1 : 0;
}

// The butterfly over the warp's teams: every thread ends with its lanes'
// combine over all teams (the same on every team: combine is commutative).
template <typename TA, int R, int T, int N>
__device__ __forceinline__ void teams_combine(TA (&x)[N]) {
#pragma unroll
  for (int off = T; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      x[j] = combine<TA, R>(x[j], shfl_xor(x[j], off, 32));
    }
  }
}

// One warp's pass over its tile [lo, hi) for the query tile [q0, q0 + qn).
template <typename O, int R, typename L>
__device__ __forceinline__ void tile_pass(const CooArgs& a, int tile,
                                          long long lo, long long hi,
                                          int q0, int qn, bool first_q,
                                          bool all_active) {
  using TM = typename O::M;
  using TE = typename O::E;
  using TD = typename O::D;
  using TA = typename O::A;
  using TR = typename O::R;
  constexpr int T = L::T, NT = 32 / T, V = L::V, OV = L::OV, DV = L::DV;
  constexpr int U = L::U;
  const int lane = threadIdx.x & 31;
  const int team = lane / T;
  const int sub = lane & (T - 1);
  const TE* w = static_cast<const TE*>(a.w);

  // The open run: the run of the tile's first edge, unless a run begins
  // there (then none is open until the first step's head).
  bool open = !head_bit(a, lo);
  long long open_start = lo - 1;  // began in an earlier tile
  long long open_v = __ldg(a.dst + lo);
  TD open_d[DV];
#pragma unroll
  for (int j = 0; j < DV; ++j) open_d[j] = Num<TD>::zero();
  if (L::kReadsDst) L::property(a, open_v, sub, q0, qn, open_d);
  // This team's share of the open run.
  TA acc[OV];
#pragma unroll
  for (int j = 0; j < OV; ++j) acc[j] = identity<TA, R>();
  bool got = false;

  // U steps at a time: their sources' active flags (unless every source is
  // active), then the active sources' messages, each kind of load in
  // flight together, while the next U steps' src and edge values load;
  // then the steps one by one.
  int cs[U];
  TE evs[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long e = lo + u * NT + team;
    cs[u] = e < hi ? __ldcs(a.src + e) : -1;
    evs[u] = (L::kReadsEdge && e < hi) ? st(w + e) : Num<TE>::zero();
  }
  for (long long b0 = lo; b0 < hi; b0 += NT * U) {
    int cn[U];
    TE en[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long e = b0 + (U + u) * NT + team;
      cn[u] = e < hi ? __ldcs(a.src + e) : -1;
      en[u] = (L::kReadsEdge && e < hi) ? st(w + e) : Num<TE>::zero();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!all_active && cs[u] >= 0 && !ro(a.active + cs[u])) cs[u] = -1;
    }
    TM ms[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) L::gather(a, cs[u], sub, q0, qn, ms[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long e0 = b0 + u * NT;
      if (e0 >= hi) break;  // the whole warp
      const int c = cs[u];  // c >= 0: a valid edge
      // tile_edges is a multiple of 32 and NT divides 32: the step's edges
      // lie in one word of heads.
      const unsigned word = __ldg(a.heads + (e0 >> 5));
      unsigned hmask = NT == 32 ? word
                                : (word >> (e0 & 31)) & ((1u << NT) - 1u);
      const long long left = hi - e0;
      if (left < NT) hmask &= (1u << left) - 1u;

      // The dst and property of this team's run: its head's, or the open
      // run's before the step's first head.
      long long v = open_v;
      TD d[DV];
#pragma unroll
      for (int j = 0; j < DV; ++j) d[j] = open_d[j];
      int hl = -1;  // the team of this team's run's head in this step
      if (hmask) {
        const bool h = (hmask >> team) & 1u;
        const long long hv = h ? __ldg(a.dst + e0 + team) : 0;
        TD hd[DV];
#pragma unroll
        for (int j = 0; j < DV; ++j) hd[j] = Num<TD>::zero();
        if (L::kReadsDst && h) L::property(a, hv, sub, q0, qn, hd);
        const unsigned upto = team == 31 ? ~0u : (2u << team) - 1u;
        const unsigned below = hmask & upto;
        hl = below ? 31 - __clz(below) : -1;
        const int from = (hl < 0 ? team : hl) * T + sub;
        const long long sv = shfl(hv, from, 32);
        if (hl >= 0) v = sv;
#pragma unroll
        for (int j = 0; j < DV; ++j) {
          const TD sd = shfl(hd[j], from, 32);
          if (hl >= 0 && L::kReadsDst) d[j] = sd;
        }
      }

      TR r[OV];
      L::apply(ms[u], evs[u], d, r, sub);  // every thread together
      const bool valid = c >= 0;
      TA x[OV];
#pragma unroll
      for (int j = 0; j < OV; ++j) {
        x[j] = valid ? convert<TA>(r[j]) : identity<TA, R>();
      }
      if (!hmask) {  // the whole step is in the open run
#pragma unroll
        for (int j = 0; j < OV; ++j) acc[j] = combine<TA, R>(acc[j], x[j]);
        got = got || valid;
        continue;
      }
      const int first = __ffs(hmask) - 1;
      const int last = 31 - __clz(hmask);
      // The open run ends before the step's first head: the teams before it
      // add their edges, and the teams' shares combine.
      if (open) {
        TA o[OV];
#pragma unroll
        for (int j = 0; j < OV; ++j) {
          o[j] = team < first ? combine<TA, R>(acc[j], x[j]) : acc[j];
        }
        const bool og = __any_sync(kFull, got || (team < first && valid));
        teams_combine<TA, R, T>(o);
        if (team == 0) {
          flush<O, R, L>(a, o, og, open_start, e0 + first - 1, open_v, tile,
                         lo, sub, q0, qn, first_q);
        }
      }
      // The runs that begin in this step: a segmented inclusive scan over
      // the teams from the first head on.
      TA s[OV];
#pragma unroll
      for (int j = 0; j < OV; ++j) {
        s[j] = team >= first ? x[j] : identity<TA, R>();
      }
      bool sg = team >= first && valid;
      bool f = (hmask >> team) & 1u;
#pragma unroll
      for (int off = 1; off < NT; off <<= 1) {
        const int from = lane >= off * T ? lane - off * T : lane;
        TA p[OV];
#pragma unroll
        for (int j = 0; j < OV; ++j) p[j] = shfl(s[j], from, 32);
        const bool pg = shfl(sg, from, 32);
        const bool pf = shfl(f, from, 32);
        if (team >= off && !f) {
#pragma unroll
          for (int j = 0; j < OV; ++j) s[j] = combine<TA, R>(p[j], s[j]);
          sg = sg || pg;
          f = pf;
        }
      }
      // A run that begins and ends in the step: its last team writes it.
      if (team >= first && team < NT - 1 && ((hmask >> (team + 1)) & 1u)) {
        flush<O, R, L>(a, s, sg, e0 + hl, e0 + team, v, tile, lo, sub, q0,
                       qn, first_q);
      }
      // The run of the last head stays open; the step's last team holds its
      // share so far (the teams past the tile's end added the identity).
      const int tail = (NT - 1) * T + sub;
      open_v = shfl(v, tail, 32);
#pragma unroll
      for (int j = 0; j < DV; ++j) open_d[j] = shfl(d[j], tail, 32);
#pragma unroll
      for (int j = 0; j < OV; ++j) {
        acc[j] = team == NT - 1 ? s[j] : identity<TA, R>();
      }
      got = team == NT - 1 && sg;
      open_start = e0 + last;
      open = true;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cs[u] = cn[u];
      evs[u] = en[u];
    }
  }
  // The tile's end closes the open run.
  if (open) {
    const bool og = __any_sync(kFull, got);
    teams_combine<TA, R, T>(acc);
    if (team == 0) {
      flush<O, R, L>(a, acc, og, open_start, hi - 1, open_v, tile, lo, sub,
                     q0, qn, first_q);
    }
  }
}

// The first pass: a warp a tile, query tile by query tile, the first last
// (it alone writes recv and the carries' flags, after the others have read
// recv).
template <typename O, int R, typename L>
__global__ void __launch_bounds__(256)
    coo_gather_reduce_kernel(const CooArgs a) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (warp >= a.num_tiles) return;  // the whole warp
  const int tile = static_cast<int>(warp);
  const long long lo = warp * a.tile_edges;
  const long long hi = lo + a.tile_edges < a.cap ? lo + a.tile_edges : a.cap;
  const int tiles = (a.q + a.q_tile - 1) / a.q_tile;
  const bool all_active = volatile_load(a.frontier) != a.tag;
  for (int t = tiles - 1; t >= 0; --t) {
    const int q0 = t * a.q_tile;
    const int qn = a.q - q0 < a.q_tile ? a.q - q0 : a.q_tile;
    tile_pass<O, R, L>(a, tile, lo, hi, q0, qn, t == 0, all_active);
    __syncwarp();
  }
}

// Before the first pass, on the same stream: a block that sees an inactive
// source writes the launch's tag to the frontier word, so that where every
// source is active (PageRank, collaborative filtering) the first pass
// reads no active flag: a random read of a 32-byte sector an edge, as
// costly as a scalar message's gather (on an H100, the SSSP spill took 0.24
// ms with every source active and 0.135 with a tenth).
__global__ void __launch_bounds__(256)
    coo_gather_frontier_kernel(const CooArgs a) {
  bool inactive = false;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (a.flags & kCooVecActive) {
    const uint4* a16 = reinterpret_cast<const uint4*>(a.active);
    done = a.n_src / 16 * 16;
    for (long long v = first; v < a.n_src / 16; v += threads) {
      const uint4 x = __ldcs(a16 + v);
      inactive = inactive || (x.x & x.y & x.z & x.w) != 0x01010101u;
    }
  }
  for (long long v = done + first; v < a.n_src; v += threads) {
    inactive = inactive || !st(a.active + v);
  }
  if (__syncthreads_or(inactive) && threadIdx.x == 0) {
    *static_cast<volatile unsigned*>(a.frontier) = a.tag;
  }
}

// The second pass: a warp a run that crosses tiles, which combines its
// tiles' carries in tile order.  The warp's lanes are KL output lanes by
// 32 / KL strides of tiles; the strides combine by a butterfly.
template <typename O, int R>
__global__ void __launch_bounds__(256)
    coo_gather_carry_kernel(const CooArgs a) {
  using TA = typename O::A;
  using TR = typename O::R;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (warp >= a.num_splits) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int4 sp = __ldg(a.splits + warp);
  const int t0 = sp.x, t1 = sp.y, first_slot = sp.z;
  const long long v = sp.w;
  bool got = false;
  for (int t = t0 + lane; t <= t1; t += 32) {
    got = got || a.carry_got[t * 2LL + (t == t0 ? first_slot : 0)];
  }
  if (!__any_sync(kFull, got)) return;
  int kl = 1;
  while (kl < a.k_out && kl < 32) kl <<= 1;
  const int stride = 32 / kl;
  const int kk = lane & (kl - 1);
  const int t_first = t0 + lane / kl;
  const TA* carry = static_cast<const TA*>(a.carry);
  const bool prior = (a.flags & kCooMerge) && a.recv[v];
  TR* y = static_cast<TR*>(a.y) + v * a.k_out;
  for (int k0 = 0; k0 < a.k_out; k0 += kl) {
    const int k = k0 + kk;
    TA x = identity<TA, R>();
    if (k < a.k_out) {
      int t = t_first;
      for (; t + 3 * stride <= t1; t += 4 * stride) {
        TA u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ti = t + i * stride;
          u[i] = carry[(ti * 2LL + (ti == t0 ? first_slot : 0)) * a.k_out + k];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) x = combine<TA, R>(x, u[i]);
      }
      for (; t <= t1; t += stride) {
        x = combine<TA, R>(
            x, carry[(t * 2LL + (t == t0 ? first_slot : 0)) * a.k_out + k]);
      }
    }
    for (int off = kl; off < 32; off <<= 1) {
      x = combine<TA, R>(x, shfl_xor(x, off, 32));
    }
    if (lane < kl && k < a.k_out) {
      const TR r = convert<TR>(x);
      y[k] = prior ? combine<TR, R>(y[k], r) : r;
    }
  }
  if (lane == 0 && a.recv != nullptr) a.recv[v] = 1;
}

// Validates the arguments, makes the stream's device current, launches the
// frontier pass and the two passes on `stream` (the second only where a run
// crosses tiles) and
// returns cudaGetLastError() after them (cudaErrorInvalidValue for
// arguments the kernels do not take).  MIX: P mixes the lanes of a K-lane
// message; else P is lanewise, and q_tile 1 or up to 8 picks the instance.
template <typename O, int R, typename P, bool MIX = false>
int run_coo(const CooArgs& args, int device, void* stream) {
  bool bad = args.src == nullptr || args.heads == nullptr ||
             args.dst == nullptr || args.frontier == nullptr ||
             args.n_src < 1 || args.cap < 1 || args.tile_edges < 32 ||
             args.tile_edges % 32 != 0 || args.num_tiles < 1 ||
             args.num_splits < 0 || args.q < 1 || args.k_out < 1 ||
             (args.num_splits > 0 &&
              (args.splits == nullptr || args.carry == nullptr ||
               args.carry_got == nullptr)) ||
             ((args.flags & kCooMerge) && args.recv == nullptr) ||
             (P::kReadsDst && args.dprop == nullptr);
  if constexpr (MIX) {
    bad = bad || args.q != P::kLanes || args.q_tile != P::kLanes ||
          (P::kReadsDst && args.kd != P::kDstLanes);
  } else {
    bad = bad || args.q_tile < 1 || args.q_tile > 8 ||
          (P::kReadsDst && args.kd != 1 && args.kd != args.q);
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  if (cudaGetDevice(&current) != cudaSuccess) {
    return static_cast<int>(cudaGetLastError());
  }
  if (current != device && cudaSetDevice(device) != cudaSuccess) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long scan = (args.n_src + 16 * threads - 1) / (16 * threads);
  const int scan_blocks = static_cast<int>(scan < 1024 ? scan : 1024);
  coo_gather_frontier_kernel<<<scan_blocks, threads, 0, s>>>(args);
  const int tile_blocks = (args.num_tiles + 7) / 8;
  if constexpr (MIX) {
    coo_gather_reduce_kernel<O, R, Mixing<O, P>>
        <<<tile_blocks, threads, 0, s>>>(args);
  } else if (args.q_tile == 1) {
    coo_gather_reduce_kernel<O, R, Lanewise<O, P, 1>>
        <<<tile_blocks, threads, 0, s>>>(args);
  } else {
    coo_gather_reduce_kernel<O, R, Lanewise<O, P, 8>>
        <<<tile_blocks, threads, 0, s>>>(args);
  }
  if (args.num_splits > 0) {
    const int split_blocks = (args.num_splits + 7) / 8;
    coo_gather_carry_kernel<O, R><<<split_blocks, threads, 0, s>>>(args);
  }
  const cudaError_t err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // namespace
