"""ell_kernel_ms.cf: card milliseconds, for a CF sweep (phase U, then phase
V), in the port's hand-written ELL kernels (phase U's lane-vector grid and
its all-active pass); moves cf_sweep_ms."""

from graphbench.readers import device_ms


def read(rec):
  return device_ms(rec, "ell")
