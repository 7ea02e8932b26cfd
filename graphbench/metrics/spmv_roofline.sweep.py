"""spmv_roofline.sweep: the whole step's share (%) of the HBM roofline: the
bytes a PageRank sweep needs (graphbench.roofline, from the benchmark's own
edge list, every vertex active) for every sweep of the window, over the
window's wall time, at 3.35 TB/s; moves sweep_ms."""

from graphbench.readers import roofline_percent


def read(rec):
  return roofline_percent(rec)
