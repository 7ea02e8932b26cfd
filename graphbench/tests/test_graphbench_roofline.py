"""The byte-count rule of the roofline shares."""

import torch

from graphbench import roofline
from graphbench.peaks import H100_BYTES_PER_S


def test_spmv_bytes_rule():
  # 10 edges with 4-byte values from 3 sources into 5 destinations.
  assert roofline.spmv_bytes(10, 3, 5, value_bytes=4, message_bytes=4,
                             reads_destination=False) == 10 * 8 + 3 * 4 + 5 * 4
  # A process that reads the destination reads its vector once more.
  assert roofline.spmv_bytes(10, 3, 5, value_bytes=4, message_bytes=64,
                             reads_destination=True) == (
                                 10 * 8 + 3 * 64 + 5 * 128)


def test_frontier_bytes_sums_lanes_and_steps():
  f = [torch.tensor([[1, 2], [3, 4], [5, 6]]), torch.tensor([[1, 0], [1, 0],
                                                             [1, 0]])]
  want = (roofline.spmv_bytes(7, 3, 11, value_bytes=4, message_bytes=4,
                              reads_destination=False)
          + roofline.spmv_bytes(1, 1, 1, value_bytes=4, message_bytes=4,
                                reads_destination=False))
  assert roofline.frontier_bytes(f, 4, 4) == want


def test_pagerank_sweep_bytes():
  e = {"src": torch.tensor([0, 1, 2, 2]), "dst": torch.tensor([1, 2, 0, 3])}
  # 4 edge indices, 3 senders, 4 receivers; no edge value.
  assert roofline.pagerank_sweep_bytes(e, 5) == 4 * 4 + 3 * 4 + 4 * 4


def test_cf_sweep_bytes():
  d = {"rating": torch.ones(6), "user": torch.tensor([0, 0, 1, 1, 2, 2]),
       "item": torch.tensor([0, 1, 0, 1, 0, 1])}
  one_u = 6 * 8 + 2 * 16 + 3 * 32
  one_v = 6 * 8 + 3 * 16 + 2 * 32
  assert roofline.cf_sweep_bytes(d, 4) == one_u + one_v


def test_tc_bytes():
  # DAG 0->1, 0->2, 1->2, 2->3: out-degrees 2, 1, 1, 0.
  dag = {"src": torch.tensor([0, 0, 1, 2]), "dst": torch.tensor([1, 2, 2, 3])}
  # Edge by edge, out(u) + out(v) entries: 2+1, 2+1, 1+1, 1+0; each edge
  # reads two lists' two offsets.
  assert roofline.tc_bytes(dag, 4) == 4 * (3 + 3 + 2 + 1) + 4 * 4 * 4


def test_share_percent():
  assert roofline.share_percent(H100_BYTES_PER_S, 1.0) == 100.0
  assert roofline.share_percent(H100_BYTES_PER_S, 4.0) == 25.0
