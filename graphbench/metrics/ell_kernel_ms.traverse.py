"""ell_kernel_ms.traverse: card milliseconds, for a superstep of a single-query traversal, in the port's
hand-written ELL kernels; moves gteps."""

from graphbench.readers import device_ms


def read(rec):
  return device_ms(rec, "ell")
