"""idle_share.tc: the share (%) of the traced window in which no operation
ran on the card; moves tc_ms."""

from graphbench.readers import idle_percent


def read(rec):
  return idle_percent(rec)
