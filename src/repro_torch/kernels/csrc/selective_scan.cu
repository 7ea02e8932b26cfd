// Mamba-1 selective scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/selective_scan.py::selective_scan_pallas.  For every
// batch row b and channel c, from h = 0 and over t = 0 .. S-1 in order:
//
//   h[n]       = exp(dt[b,t,c] * a[c,n]) * h[n] + (dt[b,t,c] * u[b,t,c]) * B[b,t,n]
//   y[b,t,c]   = sum_n h[n] * C[b,t,n]
//
// All operands and y are float32; u, dt, y are [B,S,C], a is [C,N], B and C
// are [B,S,N], all contiguous; N is at most 16.  The build uses no
// fast-math flag; the exponential is exp2f of dt times a·log2(e), a scaled
// once per lane: fewer instructions than expf (0.644 against 0.788 ms a
// launch at the Falcon-Mamba-7B prefill shape on an H100), and within
// 1.1e-5 of max|y| of the plain version there.
//
// What bounds it: u and dt are read once and y written once, 12 bytes per
// (b, t, c); B, C and a add a few MB.  At the Falcon-Mamba-7B prefill shape
// (B=4, S=2048, C=8192, N=16) that is 806.9 MB, 0.241 ms at 3.35 TB/s.  The
// exponentials, one per (b,t,c,n), take 0.257 ms at the SFU's 16 a clock
// per SM, so they set the floor; the rest of the arithmetic (7.6 GFLOP) is
// 0.113 ms at 67 TFLOP/s.  The state h (C x N floats per batch row) never
// touches device memory.  A thread that owns a whole channel (the first
// version of this kernel) gives 8 warps an SM at that shape, each running
// a 16-long chain per step, and sits 10x above the floor: latency, not
// bytes or operations, held it back.
//
// Design:
// * NL lanes per (batch row, channel), NL in {2, 4, 8, 16} (a template
//   parameter; the wrapper picks the fewest that give the grid 2^16
//   threads): each lane keeps N/NL states of h and of a in registers.  That
//   gives NL times the threads of one thread per channel and cuts each
//   thread's chain per step from N states to N/NL.
// * y is summed over the NL lanes NL steps at a time: each lane keeps its
//   share of y for NL steps, and a reduce-scatter (NL - 1 shuffles, not
//   log2(NL) per step) leaves each lane the whole y of one of them, which
//   it stores.
// * A block covers kThreads / NL channels of one batch row and walks S in
//   order (the loop over time takes the place of the TPU grid's sequential
//   chunk axis, across which the Pallas kernel carries h in VMEM scratch).
// * Time is walked in runs of kRun steps.  Each run's u, dt (the block's
//   channels) and B, C rows are copied into shared memory with cp.async,
//   double-buffered: run k+1's copies are in flight while run k is
//   stepped.  Ragged edges (S not a multiple of kRun, C not a multiple of
//   the block's channels, N below the compiled width) are masked; a full N
//   compiles without the mask.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kRun = 16;       // timesteps staged in shared memory at once
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int NL, int NMAX>
struct Stage {
  static constexpr int kCh = kThreads / NL;  // channels per block
  float u[2][kRun][kCh];
  float dt[2][kRun][kCh];
  __align__(16) float b[2][kRun][NMAX];
  __align__(16) float c[2][kRun][NMAX];
};

// Copy run [t0, t0 + run) of this block's u, dt columns and of the batch
// row's B and C into buffer `buf` (one group of cp.async).
template <int NL, int NMAX>
__device__ __forceinline__ void stage_run(Stage<NL, NMAX>& st, int buf,
                                          const float* u, const float* dt,
                                          const float* bmat,
                                          const float* cmat, long long row0,
                                          int t0, int run, int c0,
                                          int channels, int nstate) {
  constexpr int kCh = Stage<NL, NMAX>::kCh;
  for (int k = threadIdx.x; k < kRun * kCh; k += kThreads) {
    const int i = k / kCh, j = k % kCh;
    if (i < run && c0 + j < channels) {
      const long long off = (row0 + t0 + i) * channels + c0 + j;
      cp_async4(&st.u[buf][i][j], u + off);
      cp_async4(&st.dt[buf][i][j], dt + off);
    }
  }
  // B and C rows t0 .. t0+run-1 of this batch row are contiguous.
  const long long boff = (row0 + t0) * nstate;
  for (int k = threadIdx.x; k < run * nstate; k += kThreads) {
    cp_async4(&st.b[buf][k / nstate][k % nstate], bmat + boff + k);
    cp_async4(&st.c[buf][k / nstate][k % nstate], cmat + boff + k);
  }
  cp_async_commit();
}

template <int NL, int NMAX, bool FULL>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const float* __restrict__ bmat,
                      const float* __restrict__ cmat,
                      float* __restrict__ y, int seqlen, int channels,
                      int nstate) {
  constexpr int kCh = Stage<NL, NMAX>::kCh;
  constexpr int NS = NMAX / NL;  // states per lane
  __shared__ Stage<NL, NMAX> st;

  const int ch = threadIdx.x / NL;   // channel within the block
  const int sub = threadIdx.x % NL;  // lane within the channel's group
  const int c0 = blockIdx.x * kCh;
  const int c = c0 + ch;
  const bool live = c < channels;
  const long long row0 = static_cast<long long>(blockIdx.y) * seqlen;

  // This lane's states: n = sub * NS + k (all NMAX of them when FULL).
  float a_reg[NS];
  float h[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int n = sub * NS + k;
    const float av = (live && (FULL || n < nstate))
                         ? a[static_cast<long long>(c) * nstate + n] : 0.0f;
    a_reg[k] = av * kLog2e;
    h[k] = 0.0f;
  }

  stage_run<NL, NMAX>(st, 0, u, dt, bmat, cmat, row0, 0, min(kRun, seqlen),
                      c0, channels, nstate);
  int buf = 0;
  for (int t0 = 0; t0 < seqlen; t0 += kRun, buf ^= 1) {
    const int run = min(kRun, seqlen - t0);
    if (t0 + kRun < seqlen) {
      stage_run<NL, NMAX>(st, buf ^ 1, u, dt, bmat, cmat, row0, t0 + kRun,
                          min(kRun, seqlen - t0 - kRun), c0, channels,
                          nstate);
      cp_async_wait<1>();  // this run's group has landed; the next may fly
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // NL steps at a time: each lane sums its states' share of y for each
    // of the NL steps, then a reduce-scatter over the NL lanes (NL - 1
    // shuffles) leaves lane `sub` with the whole y of step i0 + sub.
    for (int i0 = 0; i0 < run; i0 += NL) {
      float part[NL];
#pragma unroll
      for (int s = 0; s < NL; ++s) {
        const int i = i0 + s;
        part[s] = 0.0f;
        if (i < run) {
          const float dt_v = st.dt[buf][i][ch];
          const float dtu = dt_v * st.u[buf][i][ch];
          const float* bp = &st.b[buf][i][sub * NS];
          const float* cp = &st.c[buf][i][sub * NS];
#pragma unroll
          for (int k = 0; k < NS; ++k) {
            if (FULL || sub * NS + k < nstate) {
              const float decay = exp2f(dt_v * a_reg[k]);
              h[k] = decay * h[k] + dtu * bp[k];
              part[s] += h[k] * cp[k];
            }
          }
        }
      }
#pragma unroll
      for (int o = NL / 2; o > 0; o >>= 1) {
        const bool upper = sub & o;  // keep the upper half of the steps
#pragma unroll
        for (int j = 0; j < o; ++j) {
          const float send = upper ? part[j] : part[j + o];
          const float keep = upper ? part[j + o] : part[j];
          part[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      if (live && i0 + sub < run) {
        y[(row0 + t0 + i0 + sub) * channels + c] = part[0];
      }
    }
    __syncthreads();  // the next run's copies overwrite this buffer
  }
}

struct Scan {
  const float *u, *dt, *a, *b, *c;
  float* y;
  int batch, seqlen, channels, nstate;
};

template <int NL, int NMAX>
bool launch(const Scan& p, cudaStream_t stream) {
  constexpr int kCh = Stage<NL, NMAX>::kCh;
  const dim3 grid((p.channels + kCh - 1) / kCh, p.batch);
  if (p.nstate == NMAX) {
    selective_scan_kernel<NL, NMAX, true><<<grid, kThreads, 0, stream>>>(
        p.u, p.dt, p.a, p.b, p.c, p.y, p.seqlen, p.channels, p.nstate);
  } else {
    selective_scan_kernel<NL, NMAX, false><<<grid, kThreads, 0, stream>>>(
        p.u, p.dt, p.a, p.b, p.c, p.y, p.seqlen, p.channels, p.nstate);
  }
  return true;
}

template <int NMAX>
bool launch_lanes(int lanes, const Scan& p, cudaStream_t s) {
  // Lanes beyond NMAX would hold no state: NMAX lanes take their place.
  switch (lanes < NMAX ? lanes : NMAX) {
    case 2: return launch<2, NMAX>(p, s);
    case 4: return launch<4, NMAX>(p, s);
    case 8:
      if constexpr (NMAX >= 8) return launch<8, NMAX>(p, s);
      return false;
    case 16:
      if constexpr (NMAX >= 16) return launch<16, NMAX>(p, s);
      return false;
  }
  return false;
}

bool launch_state(int lanes, const Scan& p, cudaStream_t s) {
  if (p.nstate <= 4) return launch_lanes<4>(lanes, p, s);
  if (p.nstate <= 8) return launch_lanes<8>(lanes, p, s);
  return launch_lanes<16>(lanes, p, s);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for sizes the kernel does not take: lanes must be
// 2, 4, 8 or 16).  Any error left pending by earlier work is
// cleared first, so the code returned belongs to this launch.
extern "C" int graphmat_selective_scan(const void* u, const void* dt,
                                       const void* a, const void* bmat,
                                       const void* cmat, void* y, int batch,
                                       int seqlen, int channels, int nstate,
                                       int lanes, void* stream) {
  if (batch < 1 || batch > 65535 || seqlen < 1 || channels < 1 ||
      nstate < 1 || nstate > 16 ||
      (lanes != 2 && lanes != 4 && lanes != 8 && lanes != 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scan p{static_cast<const float*>(u), static_cast<const float*>(dt),
               static_cast<const float*>(a), static_cast<const float*>(bmat),
               static_cast<const float*>(cmat), static_cast<float*>(y),
               batch, seqlen, channels, nstate};
  if (!launch_state(lanes, p, s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* graphmat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
