"""ell_kernel_ms.bc: card milliseconds, for a BC superstep (forward or
backward), in the port's hand-written ELL kernels (the query-tiled grid at
Q = 4); moves gteps."""

from graphbench.readers import device_ms


def read(rec):
  return device_ms(rec, "ell")
