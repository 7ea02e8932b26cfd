"""coo_ms.tc: card milliseconds, for a triangle count (both of its COO
SpMVs: the bitmap build's gathers and the intersect's), in PyTorch's
gather, scatter and index kernels; moves tc_ms."""

from graphbench.readers import device_ms


def read(rec):
  return device_ms(rec, "torch_index")
