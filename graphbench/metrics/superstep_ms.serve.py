"""superstep_ms.serve: the traced window's wall milliseconds over its
supersteps, as the server's own count of supersteps (Counters "supersteps"); moves queries_per_s."""

from graphbench.readers import superstep_ms


def read(rec):
  return superstep_ms(rec)
