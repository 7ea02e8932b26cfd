// The per-edge arithmetic of the ELL kernel (ell_spmv_body.cuh): Num<T>,
// the op-by-op rounded arithmetic of each type, and the process functors.
//
// A process functor is what the kernel's body is templated on: a struct with
//
//   static constexpr bool kReadsEdge;  // apply reads e (the edge value)
//   static constexpr bool kReadsDst;   // apply reads d (the destination's
//                                      // property; the launch needs dprop)
//   __device__ static T apply(T m, T e, T d);  // one lane of one edge
//
// The five shipped forms are below; kernels/process_expr.py writes one from
// a program's traced process_message (float32 and int32 functors compute
// in their type, float16 ones in float and round to half after each op, as
// eager CUDA does).
//
// Without __CUDACC__ (a host C++ compiler, given the CUDA intrinsics this
// file names) only the float and int parts are defined: the tests compile
// the generated functors for the host and hold them against the traced
// expression.

#pragma once

#include <stdint.h>
#ifdef __CUDACC__
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

#ifdef __CUDACC__
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

// A float rounded to the nearest half (a generated float16 functor's value
// after each op).
__device__ __forceinline__ float round_half(float x) {
  return __half2float(__float2half_rn(x));
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
