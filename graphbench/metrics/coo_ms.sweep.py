"""coo_ms.sweep: card milliseconds, for a PageRank sweep (every edge once), in PyTorch's
gather, scatter and index kernels (the COO scatters and gathers, the spill
merge); moves sweep_ms."""

from graphbench.readers import device_ms


def read(rec):
  return device_ms(rec, "torch_index")
