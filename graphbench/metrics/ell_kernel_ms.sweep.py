"""ell_kernel_ms.sweep: card milliseconds, for a PageRank sweep (every edge once), in the port's
hand-written ELL kernels; moves sweep_ms."""

from graphbench.readers import device_ms


def read(rec):
  return device_ms(rec, "ell")
