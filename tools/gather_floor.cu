// The gather floor of the ELL kernel's lane-vector grid on the card: a
// kernel that does nothing but read, for each slot of a list of source ids,
// that source's K-value float32 message (16 bytes a thread, a team of K / 4
// threads a message, 4 messages in flight a thread) and sum it, so that its
// time is what the same gathers in the same order cost with no ELL
// structure, no active flags and no process around them.  Built and timed
// by tools/gather_floor.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInFlight = 4;

// Team t of the grid takes slots t, t + teams, ... (consecutive teams read
// consecutive ids); each thread sums its 16 bytes of each message.
__global__ void gather_kernel(const int* ids, long long n, const float4* msg,
                              int vecs, float* out) {
  const long long thread =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long teams =
      static_cast<long long>(gridDim.x) * blockDim.x / vecs;
  const long long team = thread / vecs;
  const int sub = static_cast<int>(thread % vecs);
  float acc = 0.0f;
  for (long long i = team; i < n; i += teams * kInFlight) {
    int id[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const long long j = i + u * teams;
      id[u] = j < n ? __ldcs(ids + j) : -1;
    }
    float4 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      v[u] = id[u] >= 0
                 ? __ldg(msg + static_cast<long long>(id[u]) * vecs + sub)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      acc += v[u].x + v[u].y + v[u].z + v[u].w;
    }
  }
  out[thread] = acc;
}

}  // namespace

// Launches `blocks` blocks of `threads` threads over n ids (K = 4 * vecs
// lanes a message); returns cudaGetLastError().
extern "C" int gather_floor_launch(const void* ids, long long n,
                                   const void* msg, int vecs, void* out,
                                   int blocks, int threads, void* stream) {
  if (vecs < 1 || threads % vecs != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gather_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), n, static_cast<const float4*>(msg), vecs,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_floor_blocks(int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_kernel,
                                                threads, 0);
  return sms * per_sm;
}

extern "C" const char* graphmat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
