"""spmv_roofline.tc: the whole count's share (%) of the HBM roofline: the
bytes a merge-based count needs (graphbench.roofline.tc_bytes, from the
benchmark's own DAG) for every count of the window, over the window's wall
time, at 3.35 TB/s; moves tc_ms."""

from graphbench.readers import roofline_percent


def read(rec):
  return roofline_percent(rec)
