"""idle_share.bc: the share (%) of the traced window in which no
operation ran on the card; moves gteps."""

from graphbench.readers import idle_percent


def read(rec):
  return idle_percent(rec)
