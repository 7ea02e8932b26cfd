// The shipped instances of the generalized ELL SpMV / multi-query SpMM for
// Hopper (sm_90a): the kernel of ell_spmv_body.cuh (its header says what it
// computes, what bounds it and how it is designed) over the five process
// forms of ell_process.cuh, for float, half and int32 (one type for every
// operand) and the add, min and max reduces, each with its three launch
// variants (the cooperative single-query grid, the plain launch for tables
// of short rows, the query-tiled grid).  A half instance sums in float and
// rounds once into y, as the TPU kernel's jnp.sum sums a tile of half
// values in float32 (its min and max are the same in either type).
//
// Replaces the TPU kernel src/repro/kernels/ell_spmv.py::ell_spmv_pallas.  A
// program's traced process_message that equals one of these forms node for
// node runs here; any other is compiled into a library of its own at its
// first launch (kernels/ell_spmv.py), from a source that includes the same
// body.

#include "ell_spmv_body.cuh"

namespace {

// The forms in vertex_program.PROCESS_OPS order.
enum Op {
  kMsg = 0,
  kMsgPlusOne = 1,
  kMsgPlusEdge = 2,
  kMsgTimesEdge = 3,
  kEdgeMinusMsgDstTimesMsg = 4
};

// The reduce's accumulator for one operand type: float for half.
template <typename T>
struct SumType {
  using type = T;
};
template <>
struct SumType<__half> {
  using type = float;
};

template <typename T, int R>
int run_op(int op, const void* cols, const void* vals, const void* mask,
           const void* msg, const void* active, const void* dprop,
           const void* row_end, const void* segs, void* y, void* recv,
           void* sync, int n_src, int nseg, int num_warps, int width, int q,
           int q_tile, int kd, int flags, int warps_per_block, int n_filled,
           int device, void* stream) {
#define GRAPHMAT_RUN(P)                                                     \
  return run_ell<Operands<T, T, T, T, typename SumType<T>::type>, R, P>(   \
      cols, vals, mask, msg, active, dprop, row_end, segs, y, recv, sync,   \
      n_src, nseg, num_warps, width, q, q_tile, kd, flags, warps_per_block, \
      n_filled, 0, 0, device, stream)
  switch (op) {
    case kMsg: GRAPHMAT_RUN(ProcessMsg);
    case kMsgPlusOne: GRAPHMAT_RUN(ProcessMsgPlusOne);
    case kMsgPlusEdge: GRAPHMAT_RUN(ProcessMsgPlusEdge);
    case kMsgTimesEdge: GRAPHMAT_RUN(ProcessMsgTimesEdge);
    case kEdgeMinusMsgDstTimesMsg:
      GRAPHMAT_RUN(ProcessEdgeMinusMsgDstTimesMsg);
  }
#undef GRAPHMAT_RUN
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// One launch of the form `op` (an Op) for `dtype` (a DType: the message's,
// and the edge value's and destination property's where they are read, -1
// where not; the result's too) and `reduce` (a Reduce), K_out = Q; see
// run_ell for the return code.
extern "C" int graphmat_ell_spmv(const void* cols, const void* vals,
                                 const void* mask, const void* msg,
                                 const void* active, const void* dprop,
                                 const void* row_end, const void* segs,
                                 void* y, void* recv, void* sync,
                                 int n_src, int nseg,
                                 int num_warps, int width, int q, int q_tile,
                                 int kd, int flags, int warps_per_block,
                                 int n_filled, int n_rows, int tag,
                                 int dtype,
                                 int edge_dtype, int dst_dtype, int out_dtype,
                                 int k_out, int reduce, int op, int device,
                                 void* stream) {
  (void)n_rows;
  (void)tag;
  if ((edge_dtype != -1 && edge_dtype != dtype) ||
      (dst_dtype != -1 && dst_dtype != dtype) || out_dtype != dtype ||
      k_out != q) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define GRAPHMAT_OP(T, R)                                                  \
  return run_op<T, R>(op, cols, vals, mask, msg, active, dprop, row_end,   \
                      segs, y, recv, sync, n_src, nseg, num_warps, width,  \
                      q, q_tile, kd, flags, warps_per_block, n_filled,     \
                      device, stream)
#define GRAPHMAT_REDUCE(T)                   \
  switch (reduce) {                          \
    case kAdd: GRAPHMAT_OP(T, kAdd);         \
    case kMin: GRAPHMAT_OP(T, kMin);         \
    case kMax: GRAPHMAT_OP(T, kMax);         \
  }                                          \
  break
  switch (dtype) {
    case kF32: GRAPHMAT_REDUCE(float);
    case kF16: GRAPHMAT_REDUCE(__half);
    case kI32: GRAPHMAT_REDUCE(int);
  }
#undef GRAPHMAT_REDUCE
#undef GRAPHMAT_OP
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* graphmat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
