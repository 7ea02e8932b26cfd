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
// are [B,S,N], all contiguous; N is at most 16.  expf (not __expf), and the
// build uses no fast-math flag, so the kernel stays within the plain
// version's tolerance.
//
// What bounds it: bytes.  u and dt are read once and y written once, 12
// bytes per (b, t, c); B, C and a add a few MB.  At the Falcon-Mamba-7B
// prefill shape (B=4, S=2048, C=8192, N=16) that is 806.9 MB, 0.241 ms at
// 3.35 TB/s.  The arithmetic (7 operations per (b,t,c,n), one of them an
// exponential) is 7.6 GFLOP, 0.113 ms at the card's 67 TFLOP/s float32
// rate; the exponentials alone, at 16 per clock per SM, take about as long
// as the bytes.  The state h (C x N floats per batch row) never touches
// device memory.
//
// Design: one thread per (batch row, channel), h[N] and a[c, :] in
// registers; a block covers kThreads channels of one batch row and walks
// S in order (the loop over time takes the place of the TPU grid's
// sequential chunk axis, across which the Pallas kernel carries h in VMEM
// scratch).  Time is walked in runs of kRun steps: the block first stages
// the run's u and dt (each thread its own channel, so the loads of a warp
// are contiguous and all kRun of them are in flight together) and B and C
// (cooperatively; each row is broadcast to every thread) in shared memory,
// then steps through the run from shared memory, writing y coalesced
// across channels.  Ragged edges (S not a multiple of kRun, C not a
// multiple of kThreads, N below the compiled width) are masked.  At B=4 the
// grid has 4 x 64 blocks of 128 threads, about two blocks per SM: the
// occupancy that a later version would raise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kRun = 32;       // timesteps staged in shared memory at once

template <int NMAX>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const float* __restrict__ bmat,
                      const float* __restrict__ cmat,
                      float* __restrict__ y, int seqlen, int channels,
                      int nstate) {
  __shared__ float s_u[kRun][kThreads];
  __shared__ float s_dt[kRun][kThreads];
  __shared__ __align__(16) float s_b[kRun][NMAX];
  __shared__ __align__(16) float s_c[kRun][NMAX];

  const int tid = threadIdx.x;
  const int c = blockIdx.x * kThreads + tid;
  const bool live = c < channels;
  const long long row0 = static_cast<long long>(blockIdx.y) * seqlen;

  float a_reg[NMAX];
  float h[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    a_reg[j] = (live && j < nstate)
                   ? a[static_cast<long long>(c) * nstate + j] : 0.0f;
    h[j] = 0.0f;
  }

  for (int t0 = 0; t0 < seqlen; t0 += kRun) {
    const int run = min(kRun, seqlen - t0);
    if (live) {
      const float* up = u + (row0 + t0) * channels + c;
      const float* dtp = dt + (row0 + t0) * channels + c;
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        if (i < run) {
          s_u[i][tid] = up[static_cast<long long>(i) * channels];
          s_dt[i][tid] = dtp[static_cast<long long>(i) * channels];
        }
      }
    }
    // B and C rows t0 .. t0+run-1 of this batch row are contiguous.
    const float* bp = bmat + (row0 + t0) * nstate;
    const float* cp = cmat + (row0 + t0) * nstate;
    for (int k = tid; k < run * nstate; k += kThreads) {
      s_b[k / nstate][k % nstate] = bp[k];
      s_c[k / nstate][k % nstate] = cp[k];
    }
    __syncthreads();

    if (live) {
      float* yp = y + (row0 + t0) * channels + c;
      for (int i = 0; i < run; ++i) {
        const float dt_v = s_dt[i][tid];
        const float dtu = dt_v * s_u[i][tid];
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NMAX; ++j) {
          if (j < nstate) {
            const float decay = expf(dt_v * a_reg[j]);
            h[j] = decay * h[j] + dtu * s_b[i][j];
            acc += h[j] * s_c[i][j];
          }
        }
        yp[static_cast<long long>(i) * channels] = acc;
      }
    }
    __syncthreads();  // the next run overwrites the staged rows
  }
}

template <int NMAX>
void launch(const float* u, const float* dt, const float* a, const float* b,
            const float* c, float* y, int batch, int seqlen, int channels,
            int nstate, cudaStream_t stream) {
  const dim3 grid((channels + kThreads - 1) / kThreads, batch);
  selective_scan_kernel<NMAX><<<grid, kThreads, 0, stream>>>(
      u, dt, a, b, c, y, seqlen, channels, nstate);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for sizes the kernel does not take).  Any error
// left pending by earlier work is cleared first, so the code returned
// belongs to this launch.
extern "C" int graphmat_selective_scan(const void* u, const void* dt,
                                       const void* a, const void* bmat,
                                       const void* cmat, void* y, int batch,
                                       int seqlen, int channels, int nstate,
                                       void* stream) {
  if (batch < 1 || batch > 65535 || seqlen < 1 || channels < 1 ||
      nstate < 1 || nstate > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(bmat);
  const float* cf = static_cast<const float*>(cmat);
  float* yf = static_cast<float*>(y);
  if (nstate <= 4) {
    launch<4>(uf, dtf, af, bf, cf, yf, batch, seqlen, channels, nstate, s);
  } else if (nstate <= 8) {
    launch<8>(uf, dtf, af, bf, cf, yf, batch, seqlen, channels, nstate, s);
  } else {
    launch<16>(uf, dtf, af, bf, cf, yf, batch, seqlen, channels, nstate, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* graphmat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
