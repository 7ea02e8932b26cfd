"""ell_kernel_ms.serve: card milliseconds, for a superstep of the served engine, in the port's
hand-written ELL kernels; moves queries_per_s."""

from graphbench.readers import device_ms


def read(rec):
  return device_ms(rec, "ell")
