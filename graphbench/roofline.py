"""The bytes a generalized SpMV needs, counted from the benchmark's own
edge list and the reference's frontiers, whatever layout or kernel the
program uses: each out-edge of an active source read once (its index, 4
bytes, and its value, where the process reads it), each active source's
message read once, each destination's property read once where the process
reads it, and each destination's result written once.  Over the HBM peak
and the wall time of the steps, it gives the whole step's roofline share."""

from __future__ import annotations

from typing import Dict

import torch

from graphbench.peaks import H100_BYTES_PER_S

INDEX = 4


def spmv_bytes(edges: int, sources: int, destinations: int, *,
               value_bytes: int, message_bytes: int,
               reads_destination: bool) -> int:
  """One SpMV's bytes: ``edges`` active out-edges from ``sources`` into
  ``destinations``."""
  dst_bytes = message_bytes * (2 if reads_destination else 1)
  return (edges * (INDEX + value_bytes) + sources * message_bytes
          + destinations * dst_bytes)


def frontier_bytes(frontiers, value_bytes: int, message_bytes: int) -> int:
  """Bytes of every superstep of every lane, from the reference's frontier
  sizes (``[3, Q]`` each: sources, their out-edges, destinations)."""
  total = 0
  for f in frontiers:
    sources, out_edges, reached = (int(x) for x in f.sum(dim=1))
    total += spmv_bytes(out_edges, sources, reached, value_bytes=value_bytes,
                        message_bytes=message_bytes, reads_destination=False)
  return total


def pagerank_sweep_bytes(edges: Dict[str, torch.Tensor], n: int) -> int:
  """A sweep with every vertex active; PageRank's process reads no edge
  value."""
  senders = int((torch.bincount(edges["src"], minlength=n) > 0).sum())
  receivers = int((torch.bincount(edges["dst"], minlength=n) > 0).sum())
  return spmv_bytes(edges["src"].numel(), senders, receivers, value_bytes=0,
                    message_bytes=4, reads_destination=False)


def cf_sweep_bytes(data: Dict[str, object], k: int) -> int:
  """Phase U (items to users) and phase V (users to items), each reading
  every rating's index and value, the senders' K-vectors, and the
  receivers' K-vectors, and writing the receivers'."""
  e = int(data["rating"].numel())
  users = int(torch.unique(data["user"]).numel())
  items = int(torch.unique(data["item"]).numel())
  one = dict(value_bytes=4, message_bytes=4 * k, reads_destination=True)
  return (spmv_bytes(e, items, users, **one)
          + spmv_bytes(e, users, items, **one))


def tc_bytes(dag: Dict[str, torch.Tensor], n: int) -> int:
  """One triangle count by merging out-lists, whatever implements it: for
  each DAG edge ``u -> v``, ``u``'s and ``v``'s out-lists read once (an
  index an entry) and each list's two offsets."""
  out_deg = torch.bincount(dag["src"], minlength=n)
  entries = int(out_deg[dag["src"]].sum()) + int(out_deg[dag["dst"]].sum())
  return INDEX * (entries + 4 * dag["src"].numel())


def share_percent(nbytes: float, seconds: float) -> float:
  return 100.0 * nbytes / H100_BYTES_PER_S / seconds
