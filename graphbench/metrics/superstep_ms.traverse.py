"""superstep_ms.traverse: the traced window's wall milliseconds over its
supersteps, as the ELL kernel's own count of launches, one a superstep; moves gteps."""

from graphbench.readers import superstep_ms


def read(rec):
  return superstep_ms(rec)
