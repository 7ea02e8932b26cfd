"""superstep_ms.bc: the traced window's wall milliseconds over its BC
supersteps, forward and backward, as the port's own count of them
(``algos.bc.supersteps``); moves gteps."""

from graphbench.readers import superstep_ms


def read(rec):
  return superstep_ms(rec)
