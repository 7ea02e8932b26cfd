"""coo_ms.traverse: card milliseconds, for a superstep of a single-query traversal, in PyTorch's
gather, scatter and index kernels (the COO scatters and gathers, the spill
merge); moves gteps."""

from graphbench.readers import device_ms


def read(rec):
  return device_ms(rec, "torch_index")
