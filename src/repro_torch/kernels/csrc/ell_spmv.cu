// Generalized ELL SpMV / multi-query SpMM for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ell_spmv.py::ell_spmv_pallas,
// both of its grids: the single-query grid (Q = 1) and the block_queries
// multi-query SpMM grid (Q > 1, lanewise programs).  For every packed ELL
// row r and query lane q:
//
//   y[r, q] = REDUCE_s { process(msg[cols[r, s], q], vals[r, s])
//                        : mask[r, s] && active[cols[r, s]] }
//   recv[r] = any_s (mask[r, s] && active[cols[r, s]])
//
// REDUCE is add, min or max; a row with no valid slot gets the reduce
// identity and recv = 0; a NaN among a row's values makes its min or max
// NaN, as torch.amin/amax do.  process is one of four fixed forms (the Python
// callable that Pallas traces into its body cannot be compiled here):
// msg, msg + 1, msg + edge, msg * edge.  Types: float, half, int32; the sum
// is kept in the output type, as the TPU kernel keeps it.
//
// What bounds it: bytes.  Per ELL slot the kernel reads 1 byte of mask and,
// for the slots the mask marks, 4 bytes of cols and (for the two forms that
// read the edge) 4 bytes of vals; then a gather of Q message values and one
// active byte per valid slot.  There are no operations to speak of.  A
// kernel that read every slot of the ELL arrays would move 9 bytes a slot
// (5 for the forms that ignore the edge value) plus the gathers.
//
// Design: one warp per packed row; the lanes stride the row's slots, so the
// mask, cols and vals loads of a warp are contiguous.  A lane reads cols and
// vals only where the mask is set, so the padding slots of the ELL layout
// cost one mask byte each.  Each lane keeps up to QT query accumulators (a
// query tile, blockIdx.y); the warp combines them with __shfl_xor_sync.
// The Pallas kernel carries y across its innermost slot grid axis; here the
// slot loop inside the warp takes that place, so nothing is carried between
// blocks and no atomics are needed.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Reduce { kAdd = 0, kMin = 1, kMax = 2 };
enum Op { kMsg = 0, kMsgPlusOne = 1, kMsgPlusEdge = 2, kMsgTimesEdge = 3 };
enum DType { kF32 = 0, kF16 = 1, kI32 = 2 };

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float add(float a, float b) { return a + b; }
  __device__ static float mul(float a, float b) { return a * b; }
  // NaN wins, as in torch.amin/amax (fminf/fmaxf would drop it); a != a
  // holds only for NaN.
  __device__ static float min(float a, float b) {
    return (a < b || a != a) ? a : b;
  }
  __device__ static float max(float a, float b) {
    return (a > b || a != a) ? a : b;
  }
  __device__ static float zero() { return 0.0f; }
  __device__ static float one() { return 1.0f; }
  __device__ static float top() { return __uint_as_float(0x7f800000u); }
  __device__ static float bottom() { return __uint_as_float(0xff800000u); }
};

template <>
struct Num<__half> {
  __device__ static __half add(__half a, __half b) { return __hadd(a, b); }
  __device__ static __half mul(__half a, __half b) { return __hmul(a, b); }
  __device__ static __half min(__half a, __half b) { return __hmin_nan(a, b); }
  __device__ static __half max(__half a, __half b) { return __hmax_nan(a, b); }
  __device__ static __half zero() { return __ushort_as_half(0x0000); }
  __device__ static __half one() { return __ushort_as_half(0x3c00); }
  __device__ static __half top() { return __ushort_as_half(0x7c00); }
  __device__ static __half bottom() { return __ushort_as_half(0xfc00); }
};

template <>
struct Num<int> {
  // Two's-complement wrap-around, as int32 arithmetic wraps in the reference.
  __device__ static int add(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
  }
  __device__ static int mul(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
  }
  __device__ static int min(int a, int b) { return a < b ? a : b; }
  __device__ static int max(int a, int b) { return a > b ? a : b; }
  __device__ static int zero() { return 0; }
  __device__ static int one() { return 1; }
  __device__ static int top() { return 0x7fffffff; }
  __device__ static int bottom() { return -0x7fffffff - 1; }
};

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

template <typename T, int OP>
__device__ __forceinline__ T process(T m, T e) {
  if (OP == kMsg) return m;
  if (OP == kMsgPlusOne) return Num<T>::add(m, Num<T>::one());
  if (OP == kMsgPlusEdge) return Num<T>::add(m, e);
  return Num<T>::mul(m, e);
}

// One warp per packed row, a QT-wide query tile per blockIdx.y; lanes
// [q0, q0 + qn) of the message and output rows belong to this tile.
template <typename T, int R, int OP, int QT>
__global__ void ell_spmv_kernel(const int* __restrict__ cols,
                                const T* __restrict__ vals,
                                const uint8_t* __restrict__ mask,
                                const T* __restrict__ msg,
                                const uint8_t* __restrict__ active,
                                T* __restrict__ y, int8_t* __restrict__ recv,
                                long long n_pad, int width, int q,
                                int q_tile) {
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_pad) return;  // the whole warp leaves together
  const int q0 = blockIdx.y * q_tile;
  const int qn = min(q_tile, q - q0);

  T acc[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) acc[j] = identity<T, R>();
  bool got = false;

  const long long base = row * width;
  for (int s = lane; s < width; s += 32) {
    if (!mask[base + s]) continue;
    const int c = cols[base + s];
    if (!active[c]) continue;
    got = true;
    T e = Num<T>::zero();
    if (OP == kMsgPlusEdge || OP == kMsgTimesEdge) e = vals[base + s];
    const T* m = msg + static_cast<long long>(c) * q + q0;
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      if (j < qn) acc[j] = combine<T, R>(acc[j], process<T, OP>(m[j], e));
    }
  }

#pragma unroll
  for (int j = 0; j < QT; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[j] = combine<T, R>(acc[j], __shfl_xor_sync(0xffffffffu, acc[j], off));
    }
  }
  got = __any_sync(0xffffffffu, got);

  T* out = y + row * q + q0;
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    if (lane == j && j < qn) out[j] = acc[j];
  }
  if (lane == 0 && blockIdx.y == 0) recv[row] = got ? 1 : 0;
}

template <typename T, int R, int OP>
void launch(const void* cols, const void* vals, const void* mask,
            const void* msg, const void* active, void* y, void* recv,
            long long n_pad, int width, int q, int q_tile, int rows_per_block,
            cudaStream_t stream) {
  const dim3 block(32 * rows_per_block);
  const dim3 grid(static_cast<unsigned>((n_pad + rows_per_block - 1) / rows_per_block),
                  static_cast<unsigned>((q + q_tile - 1) / q_tile));
  const int* c = static_cast<const int*>(cols);
  const T* v = static_cast<const T*>(vals);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  const T* m = static_cast<const T*>(msg);
  const uint8_t* a = static_cast<const uint8_t*>(active);
  T* out = static_cast<T*>(y);
  int8_t* rv = static_cast<int8_t*>(recv);
  if (q_tile == 1) {
    ell_spmv_kernel<T, R, OP, 1><<<grid, block, 0, stream>>>(
        c, v, mk, m, a, out, rv, n_pad, width, q, q_tile);
  } else {
    ell_spmv_kernel<T, R, OP, 8><<<grid, block, 0, stream>>>(
        c, v, mk, m, a, out, rv, n_pad, width, q, q_tile);
  }
}

template <typename T, int R>
bool launch_op(int op, const void* cols, const void* vals, const void* mask,
               const void* msg, const void* active, void* y, void* recv,
               long long n_pad, int width, int q, int q_tile,
               int rows_per_block, cudaStream_t stream) {
  switch (op) {
    case kMsg:
      launch<T, R, kMsg>(cols, vals, mask, msg, active, y, recv, n_pad, width,
                         q, q_tile, rows_per_block, stream);
      return true;
    case kMsgPlusOne:
      launch<T, R, kMsgPlusOne>(cols, vals, mask, msg, active, y, recv, n_pad,
                                width, q, q_tile, rows_per_block, stream);
      return true;
    case kMsgPlusEdge:
      launch<T, R, kMsgPlusEdge>(cols, vals, mask, msg, active, y, recv,
                                 n_pad, width, q, q_tile, rows_per_block,
                                 stream);
      return true;
    case kMsgTimesEdge:
      launch<T, R, kMsgTimesEdge>(cols, vals, mask, msg, active, y, recv,
                                  n_pad, width, q, q_tile, rows_per_block,
                                  stream);
      return true;
  }
  return false;
}

template <typename T>
bool launch_reduce(int reduce, int op, const void* cols, const void* vals,
                   const void* mask, const void* msg, const void* active,
                   void* y, void* recv, long long n_pad, int width, int q,
                   int q_tile, int rows_per_block, cudaStream_t stream) {
  switch (reduce) {
    case kAdd:
      return launch_op<T, kAdd>(op, cols, vals, mask, msg, active, y, recv,
                                n_pad, width, q, q_tile, rows_per_block,
                                stream);
    case kMin:
      return launch_op<T, kMin>(op, cols, vals, mask, msg, active, y, recv,
                                n_pad, width, q, q_tile, rows_per_block,
                                stream);
    case kMax:
      return launch_op<T, kMax>(op, cols, vals, mask, msg, active, y, recv,
                                n_pad, width, q, q_tile, rows_per_block,
                                stream);
  }
  return false;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take).  Any
// error left pending by earlier work is cleared first, so the code returned
// belongs to this launch.
extern "C" int graphmat_ell_spmv(const void* cols, const void* vals,
                                 const void* mask, const void* msg,
                                 const void* active, void* y, void* recv,
                                 long long n_pad, int width, int q,
                                 int q_tile, int rows_per_block, int dtype,
                                 int reduce, int op, void* stream) {
  if (n_pad < 1 || width < 1 || q < 1 || q_tile < 1 || q_tile > 8 ||
      rows_per_block < 1 || rows_per_block > 32 ||
      (q + q_tile - 1) / q_tile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (dtype) {
    case kF32:
      ok = launch_reduce<float>(reduce, op, cols, vals, mask, msg, active, y,
                                recv, n_pad, width, q, q_tile, rows_per_block,
                                s);
      break;
    case kF16:
      ok = launch_reduce<__half>(reduce, op, cols, vals, mask, msg, active, y,
                                 recv, n_pad, width, q, q_tile,
                                 rows_per_block, s);
      break;
    case kI32:
      ok = launch_reduce<int>(reduce, op, cols, vals, mask, msg, active, y,
                              recv, n_pad, width, q, q_tile, rows_per_block,
                              s);
      break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* graphmat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
