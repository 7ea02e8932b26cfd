"""idle_share.serve: the share (%) of the traced window in which no
operation ran on the card; moves queries_per_s."""

from graphbench.readers import idle_percent


def read(rec):
  return idle_percent(rec)
