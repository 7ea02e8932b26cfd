"""Triangle counting (port of :mod:`repro.algos.triangle_count`): two vertex
programs.

(1) Each vertex builds its out-neighbour list as a packed bitmap: a program
on the reversed graph whose messages are one-hot rows, reduced with the
*generic* bitwise-or monoid.  (2) Each vertex sends its bitmap along its
out-edges; the receiver intersects it with its own, ``popcount(m & mine)``.
On a DAG-oriented graph (u < v for every edge) each triangle is counted
once: for edge u -> v, ``|out(u) ∩ out(v)|`` counts the w with u < v < w.

The bitmaps are int32 words where the reference has uint32: torch's
uint32 lacks ``~``, shifts, comparisons and ``index_put_``.  Bit 31 is the
word's sign bit; viewed as uint32 the words equal the reference's.  Torch
has no popcount, so :func:`popcount32` counts bits with shifts and masks.
"""

from __future__ import annotations

import torch

from repro_torch import _tree
from repro_torch.core.backends.plan import PlanLike
from repro_torch.core.engine import run_fixed_iters
from repro_torch.core.vertex_program import GraphProgram


def n_words(n: int) -> int:
  return (n + 31) // 32


def bit_values(device=None) -> torch.Tensor:
  """int32[32]: the word with only bit b set, for b = 0..31 (bit 31 is
  ``-2**31``)."""
  return torch.tensor([1 << b for b in range(31)] + [-2**31],
                      dtype=torch.int32, device=device)


def onehot_bitmap(n: int, device=None) -> torch.Tensor:
  """int32[n, n_words]: bit v set in row v."""
  v = torch.arange(n, device=device)
  out = torch.zeros((n, n_words(n)), dtype=torch.int32, device=device)
  out[v, v // 32] = bit_values(device)[v % 32]
  return out


def popcount32(x: torch.Tensor) -> torch.Tensor:
  """Set bits of each int32 word, as int32 (a SWAR count).  The sign bit is
  counted apart, so the count runs on non-negative words, where ``>>`` is
  logical and no step overflows.  The steps run in place on one fresh word
  tensor and one temporary, since triangle counting calls it on [E, n/32]
  words."""
  y = x & 0x7FFFFFFF
  t = y >> 1
  y -= t.bitwise_and_(0x55555555)
  t = y >> 2
  y.bitwise_and_(0x33333333).add_(t.bitwise_and_(0x33333333))
  t = y >> 4
  y.add_(t).bitwise_and_(0x0F0F0F0F)
  t = y >> 8
  y += t
  t = y >> 16
  y.add_(t).bitwise_and_(0x3F)
  del t
  return y.add_(x < 0)


def bitmap_build_program() -> GraphProgram:
  """Phase 1 (on the REVERSED graph): u receives one-hot(v) for each
  out-edge u -> v; the OR-reduce accumulates out(u)."""
  return GraphProgram(
      process_message=lambda m, e, d: m,
      reduce_kind="generic",
      reduce=lambda a, b: _tree.tree_map(torch.bitwise_or, a, b),
      reduce_identity=0,
      apply=torch.bitwise_or,
      process_reads_dst=False,
      num_message_dims=1,
      name="tc_bitmap_build")


def intersect_program() -> GraphProgram:
  """Phase 2 (forward graph): v intersects each incoming out(u) with its
  own out(v)."""

  def process(m, e, d):
    # m: sender bitmaps [*edges, W]; d: receiver {"bits": [*edges, W], ...}.
    return popcount32(m & d["bits"]).sum(dim=-1, dtype=torch.int32)

  def apply(red, old):
    return {"bits": old["bits"], "count": old["count"] + red}

  return GraphProgram(
      process_message=process,
      reduce_kind="add",
      send_message=lambda p: p["bits"],
      apply=apply,
      process_reads_dst=True,
      name="tc_intersect")


def triangle_count(fwd_graph, rev_graph, n: int, *,
                   backend: PlanLike = "auto") -> torch.Tensor:
  """Count the triangles of a DAG-oriented graph (``dag_orient`` edges as
  ``fwd_graph``, the same edges reversed as ``rev_graph``).  Returns an
  exact int64 scalar on the graphs' device."""
  dev = fwd_graph.device
  oh = onehot_bitmap(n, dev)
  everyone = torch.ones((n,), dtype=torch.bool, device=dev)
  # The message a vertex sends is its property, so seed the property with
  # the one-hot rows and strip the self bit afterwards.
  state = run_fixed_iters(rev_graph, bitmap_build_program(), oh, everyone, 1,
                          backend=backend)
  bits = state.prop & ~oh
  del state, oh
  prop = {"bits": bits, "count": torch.zeros((n,), dtype=torch.int32,
                                             device=dev)}
  state = run_fixed_iters(fwd_graph, intersect_program(), prop, everyone, 1,
                          backend=backend)
  return state.prop["count"].sum(dtype=torch.int64)
