"""coo_ms.bc: card milliseconds, for a BC superstep, in the kernels of the
COO path as every coo_ms reader names them (gather, scatter and index:
here the spill merge on the COO kernel, and PyTorch's gathers around the
ELL rows); moves gteps."""

from graphbench.readers import device_ms


def read(rec):
  return device_ms(rec, "torch_index")
