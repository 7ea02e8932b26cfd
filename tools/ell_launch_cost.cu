// The ELL kernel's fixed per-launch cost on the card: empty launches of the
// kernel's resident grid, plain and cooperative, with and without the
// cooperative launch's all-active pass and grid barrier (the prologue of
// src/repro_torch/kernels/csrc/ell_spmv.cu, whose helpers this file
// includes).  Built and timed by tools/ell_launch_cost.py.

#include "../src/repro_torch/kernels/csrc/ell_spmv.cu"

namespace {

__global__ void empty_kernel(int* sink) {
  if (sink != nullptr && threadIdx.x == 0xffff) sink[0] = 1;
}

__global__ void barrier_kernel(unsigned* sync) { grid_barrier(sync); }

// The cooperative launch's prologue: the pass over the active flags, then
// (BARRIER) the grid barrier and the all-active read; else a block's
// result written.
template <bool BARRIER>
__global__ void prologue_kernel(const uint8_t* active, int n_src,
                                unsigned* sync, int* out) {
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const unsigned gen = volatile_load(sync + kGeneration);
  bool inactive = false;
  const uint4* a16 = reinterpret_cast<const uint4*>(active);
  for (long long v = first; v < n_src / 16; v += threads) {
    const uint4 w = __ldcs(a16 + v);
    inactive |= (w.x & w.y & w.z & w.w) != 0x01010101u;
  }
  for (long long v = n_src / 16 * 16 + first; v < n_src; v += threads) {
    inactive |= !ro(active + v);
  }
  const int any = __syncthreads_or(inactive);
  if (!BARRIER) {
    if (threadIdx.x == 0) out[blockIdx.x] = any;
    return;
  }
  if (any && threadIdx.x == 0) atomicAdd(sync + kInactive + (gen & 1), 1u);
  grid_barrier(sync);
  if (threadIdx.x == 0) {
    out[blockIdx.x] = volatile_load(sync + kInactive + (gen & 1)) == 0u;
  }
}

}  // namespace

// Blocks of `threads` the cooperative ELL kernel (f32 add, Q = 1) keeps
// resident on the card.
extern "C" int ell_cost_resident(int threads) {
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ell_spmv_kernel<float, kAdd, kMsg, 1, true>, threads, 0);
  return sms * per_sm;
}

// kind: 0 plain empty, 1 cooperative empty, 2 cooperative barrier, 3 plain
// pass over the flags, 4 cooperative pass and barrier.  `active` holds
// n_src flags, 16-byte aligned; `out` one int a block.
extern "C" int ell_cost_launch(int kind, int blocks, int threads,
                               const void* active, int n_src, void* sync,
                               void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* a = static_cast<const uint8_t*>(active);
  unsigned* words = static_cast<unsigned*>(sync);
  int* o = static_cast<int*>(out);
  int* none = nullptr;
  void* empty_args[] = {&none};
  void* barrier_args[] = {&words};
  void* prologue_args[] = {&a, &n_src, &words, &o};
  cudaError_t err = cudaSuccess;
  switch (kind) {
    case 0: empty_kernel<<<blocks, threads, 0, s>>>(nullptr); break;
    case 1:
      err = cudaLaunchCooperativeKernel(
          reinterpret_cast<const void*>(empty_kernel), blocks, threads,
          empty_args, 0, s);
      break;
    case 2:
      err = cudaLaunchCooperativeKernel(
          reinterpret_cast<const void*>(barrier_kernel), blocks, threads,
          barrier_args, 0, s);
      break;
    case 3: prologue_kernel<false><<<blocks, threads, 0, s>>>(a, n_src,
                                                              words, o);
      break;
    case 4:
      err = cudaLaunchCooperativeKernel(
          reinterpret_cast<const void*>(prologue_kernel<true>), blocks,
          threads, prologue_args, 0, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
