// The shipped instances of the generalized COO SpMV for Hopper (sm_90a): the
// segmented gather-process-reduce of coo_spmv_body.cuh (its header says what
// it computes, what bounds it and how it is designed) over the five process
// forms of ell_process.cuh, for float, half and int32 (one type for every
// operand; a half instance sums in float and rounds once, as the ELL
// kernel's half forms do) and the add, min and max reduces, each for a
// single query (a query tile of 1) and for query tiles of up to 8.
//
// It replaces no TPU kernel: the reference's COO paths are XLA scatters.  A
// program's traced process_message that equals one of these forms node for
// node runs here; any other is compiled into a library of its own at its
// first launch (kernels/coo_spmv.py), from a source that includes the same
// body.

#include "coo_spmv_body.cuh"

namespace {

// The forms in vertex_program.PROCESS_OPS order (as ell_spmv.cu's).
enum CooOp {
  kCooMsg = 0,
  kCooMsgPlusOne = 1,
  kCooMsgPlusEdge = 2,
  kCooMsgTimesEdge = 3,
  kCooEdgeMinusMsgDstTimesMsg = 4
};

template <typename T>
struct CooSum {
  using type = T;
};
template <>
struct CooSum<__half> {
  using type = float;
};

template <typename T, int R>
int run_form(int op, const CooArgs& args, int device, void* stream) {
  using O = Operands<T, T, T, T, typename CooSum<T>::type>;
  switch (op) {
    case kCooMsg: return run_coo<O, R, ProcessMsg>(args, device, stream);
    case kCooMsgPlusOne:
      return run_coo<O, R, ProcessMsgPlusOne>(args, device, stream);
    case kCooMsgPlusEdge:
      return run_coo<O, R, ProcessMsgPlusEdge>(args, device, stream);
    case kCooMsgTimesEdge:
      return run_coo<O, R, ProcessMsgTimesEdge>(args, device, stream);
    case kCooEdgeMinusMsgDstTimesMsg:
      return run_coo<O, R, ProcessEdgeMinusMsgDstTimesMsg>(args, device,
                                                           stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// One call of the form `op` (a CooOp) for `dtype` (a DType of
// ell_spmv_body.cuh: the message's, and the edge value's and destination
// property's where they are read, -1 where not; the result's too) and
// `reduce` (a Reduce), K_out = Q; see run_coo for the return code.
extern "C" int graphmat_coo_spmv(
    const void* src, const void* w, const void* heads, const void* dst,
    const void* msg, const void* active, const void* dprop,
    const void* splits, void* y, void* recv, void* carry, void* carry_got,
    void* frontier, long long cap, long long n_src, int tile_edges,
    int num_tiles, int num_splits, int q, int q_tile, int kd, int k_out,
    int flags, int tag, int dtype, int edge_dtype, int dst_dtype,
    int out_dtype, int reduce, int op, int device, void* stream) {
  if ((edge_dtype != -1 && edge_dtype != dtype) ||
      (dst_dtype != -1 && dst_dtype != dtype) || out_dtype != dtype ||
      k_out != q) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CooArgs args{static_cast<const int*>(src), w,
                     static_cast<const unsigned*>(heads),
                     static_cast<const long long*>(dst), msg,
                     static_cast<const uint8_t*>(active), dprop,
                     static_cast<const int4*>(splits), y,
                     static_cast<uint8_t*>(recv), carry,
                     static_cast<uint8_t*>(carry_got),
                     static_cast<unsigned*>(frontier), cap, n_src,
                     tile_edges, num_tiles, num_splits, q, q_tile, kd,
                     k_out, flags, static_cast<unsigned>(tag)};
#define GRAPHMAT_COO_REDUCE(T)                                        \
  switch (reduce) {                                                   \
    case kAdd: return run_form<T, kAdd>(op, args, device, stream);    \
    case kMin: return run_form<T, kMin>(op, args, device, stream);    \
    case kMax: return run_form<T, kMax>(op, args, device, stream);    \
  }                                                                   \
  break
  switch (dtype) {
    case kF32: GRAPHMAT_COO_REDUCE(float);
    case kF16: GRAPHMAT_COO_REDUCE(__half);
    case kI32: GRAPHMAT_COO_REDUCE(int);
  }
#undef GRAPHMAT_COO_REDUCE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* graphmat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
