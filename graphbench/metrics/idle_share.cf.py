"""idle_share.cf: the share (%) of the traced window in which no operation
ran on the card, in the CF cells; moves cf_sweep_ms."""

from graphbench.readers import idle_percent


def read(rec):
  return idle_percent(rec)
