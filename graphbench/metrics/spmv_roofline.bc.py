"""spmv_roofline.bc: a trial's share (%) of the HBM roofline: the bytes
Brandes needs over the reference's levels of the trials checked against
it (each out-edge of a frontier vertex once, each active lane's message
once, each receiving row's result once: ``work/bc.py::level_bytes``), over
their wall time, at 3.35 TB/s; moves gteps."""

from graphbench.readers import roofline_percent


def read(rec):
  return roofline_percent(rec)
