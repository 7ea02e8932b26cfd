// The per-edge arithmetic of the ELL kernel (ell_spmv_body.cuh): Num<T>,
// the op-by-op rounded arithmetic of each type, and the process functors.
//
// A process functor is what the kernel's body is templated on: a struct with
//
//   static constexpr bool kReadsEdge;  // apply reads e (the edge value)
//   static constexpr bool kReadsDst;   // apply reads d (the destination's
//                                      // property; the launch needs dprop)
//   __device__ static R apply(M m, E e, D d);  // one lane of one edge
//
// for a lanewise process (the five shipped forms below, templated on one
// type; kernels/process_expr.py writes one from a program's traced
// process_message, with its own message, edge, destination and result
// types: float32 and the integer types compute in their type, float16 and
// bfloat16 ones in float and round after each op, as eager CUDA does; a
// double message only passes through, summed by the body in double), or,
// for a process that mixes the lane axis of a K-lane message, kLanes,
// kTeam, kVec, kLoad, kSlots, kOut, kDstLanes and
//
//   __device__ static void apply(const M (&m)[kVec], E e, const D (&d)[..],
//                                R (&out)[..], int sub);
//
// over one edge's K lanes, held kVec a thread by a team of kTeam threads
// (lanes sub * kVec + j, j < kVec, on thread sub of the team: contiguous,
// so a thread loads them kLoad at a time); a lane reduction is a sum over
// the thread's lanes and then a butterfly of shuffles within the team
// (team_sum and the like below).  Every thread of the warp calls apply
// together (the kernel calls it for empty slots too and drops the result),
// so the shuffles name the whole warp.  kSlots is the slots a team takes
// per step of its row (ell_spmv_body.cuh's lanes_kernel).
//
// Without __CUDACC__ (a host C++ compiler, given the CUDA intrinsics this
// file names) only the float and integer parts are defined: the tests
// compile the generated lanewise functors for the host and hold them
// against the traced expression.

#pragma once

#include <stdint.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#endif

namespace {

template <typename T>
struct Num;

template <>
struct Num<float> {
  // _rn intrinsics: rounded op by op, never contracted into an FMA.
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
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
struct Num<int> {
  // Two's-complement wrap-around, as int32 arithmetic wraps in the reference.
  __device__ static int add(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
  }
  __device__ static int sub(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
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

// The narrow integers wrap, as torch's int8 / int16 / uint8 arithmetic
// does (computed in int, stored back).
template <typename T, int LO, int HI>
struct NarrowNum {
  __device__ static T add(T a, T b) { return static_cast<T>(a + b); }
  __device__ static T sub(T a, T b) { return static_cast<T>(a - b); }
  __device__ static T mul(T a, T b) { return static_cast<T>(a * b); }
  __device__ static T min(T a, T b) { return a < b ? a : b; }
  __device__ static T max(T a, T b) { return a > b ? a : b; }
  __device__ static T zero() { return 0; }
  __device__ static T one() { return 1; }
  __device__ static T top() { return static_cast<T>(HI); }
  __device__ static T bottom() { return static_cast<T>(LO); }
};
template <>
struct Num<int8_t> : NarrowNum<int8_t, -128, 127> {};
template <>
struct Num<int16_t> : NarrowNum<int16_t, -32768, 32767> {};
template <>
struct Num<uint8_t> : NarrowNum<uint8_t, 0, 255> {};

#ifdef __CUDACC__
// The sums of a float64 message (GAP's path counts): rounded op by op, as
// Num<float>'s.
template <>
struct Num<double> {
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double min(double a, double b) {
    return (a < b || a != a) ? a : b;
  }
  __device__ static double max(double a, double b) {
    return (a > b || a != a) ? a : b;
  }
  __device__ static double zero() { return 0.0; }
  __device__ static double one() { return 1.0; }
  __device__ static double top() {
    return __longlong_as_double(0x7ff0000000000000ll);
  }
  __device__ static double bottom() {
    return __longlong_as_double(static_cast<long long>(0xfff0000000000000ull));
  }
};

template <>
struct Num<__half> {
  __device__ static __half add(__half a, __half b) { return __hadd(a, b); }
  __device__ static __half sub(__half a, __half b) { return __hsub(a, b); }
  __device__ static __half mul(__half a, __half b) { return __hmul(a, b); }
  __device__ static __half min(__half a, __half b) { return __hmin_nan(a, b); }
  __device__ static __half max(__half a, __half b) { return __hmax_nan(a, b); }
  __device__ static __half zero() { return __ushort_as_half(0x0000); }
  __device__ static __half one() { return __ushort_as_half(0x3c00); }
  __device__ static __half top() { return __ushort_as_half(0x7c00); }
  __device__ static __half bottom() { return __ushort_as_half(0xfc00); }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __hadd(a, b);
  }
  __device__ static __nv_bfloat16 sub(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __hsub(a, b);
  }
  __device__ static __nv_bfloat16 mul(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __hmul(a, b);
  }
  __device__ static __nv_bfloat16 min(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __hmin_nan(a, b);
  }
  __device__ static __nv_bfloat16 max(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __hmax_nan(a, b);
  }
  __device__ static __nv_bfloat16 zero() { return __ushort_as_bfloat16(0x0000); }
  __device__ static __nv_bfloat16 one() { return __ushort_as_bfloat16(0x3f80); }
  __device__ static __nv_bfloat16 top() { return __ushort_as_bfloat16(0x7f80); }
  __device__ static __nv_bfloat16 bottom() {
    return __ushort_as_bfloat16(0xff80);
  }
};

// A float rounded to the nearest half or bfloat16, ties to even (a
// generated float16 or bfloat16 functor's value after each op).
__device__ __forceinline__ float round_half(float x) {
  return __half2float(__float2half_rn(x));
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A value from another thread of the warp, for every type the kernel
// shuffles (the narrow integers through int); the whole warp takes part.
template <typename V>
__device__ __forceinline__ V shfl(V v, int src, int width) {
  return __shfl_sync(0xffffffffu, v, src, width);
}
template <typename V>
__device__ __forceinline__ V shfl_xor(V v, int mask, int width) {
  return __shfl_xor_sync(0xffffffffu, v, mask, width);
}
#define GRAPHMAT_NARROW_SHFL(T)                                             \
  template <>                                                               \
  __device__ __forceinline__ T shfl<T>(T v, int src, int width) {           \
    return static_cast<T>(                                                  \
        __shfl_sync(0xffffffffu, static_cast<int>(v), src, width));         \
  }                                                                         \
  template <>                                                               \
  __device__ __forceinline__ T shfl_xor<T>(T v, int mask, int width) {      \
    return static_cast<T>(                                                  \
        __shfl_xor_sync(0xffffffffu, static_cast<int>(v), mask, width));    \
  }
GRAPHMAT_NARROW_SHFL(int8_t)
GRAPHMAT_NARROW_SHFL(int16_t)
GRAPHMAT_NARROW_SHFL(uint8_t)
GRAPHMAT_NARROW_SHFL(bool)
#undef GRAPHMAT_NARROW_SHFL

// The lanes of one edge's team of T threads (a power of two, aligned within
// the warp): thread `src`'s value, and the sum, max and min over the team,
// the same on every thread of it (each butterfly step combines two values
// in the same order on both threads).
template <int T, typename V>
__device__ __forceinline__ V team_lane(V v, int src) {
  return T == 1 ? v : shfl(v, src, T);
}
template <int T, typename V>
__device__ __forceinline__ V team_sum(V v) {
#pragma unroll
  for (int off = T >> 1; off > 0; off >>= 1) {
    v = Num<V>::add(v, shfl_xor(v, off, T));
  }
  return v;
}
template <int T, typename V>
__device__ __forceinline__ V team_max(V v) {
#pragma unroll
  for (int off = T >> 1; off > 0; off >>= 1) {
    v = Num<V>::max(v, shfl_xor(v, off, T));
  }
  return v;
}
template <int T, typename V>
__device__ __forceinline__ V team_min(V v) {
#pragma unroll
  for (int off = T >> 1; off > 0; off >>= 1) {
    v = Num<V>::min(v, shfl_xor(v, off, T));
  }
  return v;
}
#endif

// The shipped forms (vertex_program.PROCESS_FORMS, in the same order).
struct ProcessMsg {  // m
  static constexpr bool kReadsEdge = false;
  static constexpr bool kReadsDst = false;
  template <typename T>
  __device__ __forceinline__ static T apply(T m, T, T) { return m; }
};

struct ProcessMsgPlusOne {  // m + 1
  static constexpr bool kReadsEdge = false;
  static constexpr bool kReadsDst = false;
  template <typename T>
  __device__ __forceinline__ static T apply(T m, T, T) {
    return Num<T>::add(m, Num<T>::one());
  }
};

struct ProcessMsgPlusEdge {  // m + e
  static constexpr bool kReadsEdge = true;
  static constexpr bool kReadsDst = false;
  template <typename T>
  __device__ __forceinline__ static T apply(T m, T e, T) {
    return Num<T>::add(m, e);
  }
};

struct ProcessMsgTimesEdge {  // m * e
  static constexpr bool kReadsEdge = true;
  static constexpr bool kReadsDst = false;
  template <typename T>
  __device__ __forceinline__ static T apply(T m, T e, T) {
    return Num<T>::mul(m, e);
  }
};

struct ProcessEdgeMinusMsgDstTimesMsg {  // (e - m * d) * m
  static constexpr bool kReadsEdge = true;
  static constexpr bool kReadsDst = true;
  template <typename T>
  __device__ __forceinline__ static T apply(T m, T e, T d) {
    return Num<T>::mul(Num<T>::sub(e, Num<T>::mul(m, d)), m);
  }
};

}  // namespace
