"""spmv_roofline.cf: the whole step's share (%) of the HBM roofline: the
bytes a CF sweep needs (graphbench.roofline, from the benchmark's own
ratings: both phases, every rating once each) for every sweep of the
window, over the window's wall time, at 3.35 TB/s; moves cf_sweep_ms."""

from graphbench.readers import roofline_percent


def read(rec):
  return roofline_percent(rec)
