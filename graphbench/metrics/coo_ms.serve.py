"""coo_ms.serve: card milliseconds, for a superstep of the served engine, in PyTorch's
gather, scatter and index kernels (the COO scatters and gathers, the spill
merge); moves queries_per_s."""

from graphbench.readers import device_ms


def read(rec):
  return device_ms(rec, "torch_index")
