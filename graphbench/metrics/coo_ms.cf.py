"""coo_ms.cf: card milliseconds, for a CF sweep (phase U, then phase V), in
PyTorch's gather, scatter and index kernels (phase V's coo_tiled, phase
U's spill merge); moves cf_sweep_ms."""

from graphbench.readers import device_ms


def read(rec):
  return device_ms(rec, "torch_index")
