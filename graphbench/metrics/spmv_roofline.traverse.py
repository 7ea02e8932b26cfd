"""spmv_roofline.traverse: the whole step's share (%) of the HBM roofline:
the bytes the SpMVs need (graphbench.roofline, from the benchmark's own
edge list and the reference's frontiers) for the traversals checked against the reference, over their wall time, at 3.35 TB/s;
moves gteps."""

from graphbench.readers import roofline_percent


def read(rec):
  return roofline_percent(rec)
