"""The GraphMat vertex-program API (PyTorch port of
:mod:`repro.core.vertex_program`).

The callables are written in *broadcasting form*: the JAX package vmaps
``send_message``/``apply`` over vertices and ``process_message`` over edges,
while the port calls them once on whole tensors.

* ``send_message(prop)`` and ``apply(reduced, old)`` get leaves shaped
  ``[n, ...]`` (``[n, Q, ...]`` in the batched engine).
* ``process_message(m, e, d)`` gets message leaves shaped ``[*edges, ...]``,
  the edge value ``e`` shaped ``[*edges]`` plus one trailing unit axis per
  payload axis of the first message leaf (so ``m + e`` broadcasts across a
  query axis), and the destination property ``d`` shaped ``[*edges, ...]``
  (or a broadcast dummy when ``process_reads_dst`` is False).

``process_op`` is the one field the JAX program does not have: a shorthand
that names one of the per-edge forms the CUDA ELL kernel ships compiled
(:data:`PROCESS_FORMS`).  The program then takes that form as its
``process_message``, and reads the destination property exactly when the
form does (:data:`DST_FORMS`):

* ``"msg"``: ``m`` (PageRank, delta-PageRank);
* ``"msg_plus_one"``: ``m + 1`` (BFS);
* ``"msg_plus_edge"``: ``m + e`` (SSSP, MIN_PLUS);
* ``"msg_times_edge"``: ``m * e`` (PLUS_TIMES, MAX_TIMES);
* ``"edge_minus_msg_dst_times_msg"``: ``(e - m * d) * m``, which reads the
  destination property ``d`` (the reference's ``plus_dst`` test semiring).
  It acts lane by lane, so it equals collaborative filtering's update,
  ``(e - Σ_k m_k d_k) * m``, only at K = 1.

A program without a ``process_op`` reaches the kernel too, as the
reference's reaches ``ell_spmv_pallas``: its ``process_message`` is traced
at the call's dtypes and widths, lanewise or mixing the lanes of a
``[n, K]`` message (CF's own process, where its destination property is
one leaf), and compiled into the kernel
(:mod:`repro_torch.kernels.process_expr`); a trace equal to one of the
forms runs that form's shipped instance, and a ``process_op`` program
whose dtypes the shipped library lacks runs its form's trace.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import _tree
from repro_torch.core import semiring as sr

PyTree = Any

# The per-edge forms the CUDA ELL kernel compiles (``kernels/csrc/ell_spmv.cu``
# enumerates them in this order), in broadcasting form.
PROCESS_FORMS = {
    "msg": lambda m, e, d: m,
    "msg_plus_one": lambda m, e, d: m + 1,
    "msg_plus_edge": lambda m, e, d: m + e,
    "msg_times_edge": lambda m, e, d: m * e,
    "edge_minus_msg_dst_times_msg": lambda m, e, d: (e - m * d) * m,
}
PROCESS_OPS = tuple(PROCESS_FORMS)
DST_FORMS = frozenset({"edge_minus_msg_dst_times_msg"})  # forms that read d


def _default_activate(old: PyTree, new: PyTree) -> torch.Tensor:
  """Active iff any leaf differs (per vertex, reducing over trailing dims)."""
  out = None
  for o, n in zip(_tree.tree_leaves(old), _tree.tree_leaves(new)):
    d = o != n
    if d.ndim > 1:  # reduce trailing payload dims, keep the vertex axis
      d = d.reshape(d.shape[0], -1).any(dim=-1)
    out = d if out is None else out | d
  return out


def lanewise_activate(old: PyTree, new: PyTree) -> torch.Tensor:
  """Per-lane activation for batched programs: leaves ``[n, Q, ...]`` give a
  ``bool[n, Q]`` frontier (payload dims beyond the query axis reduced)."""
  out = None
  for o, n in zip(_tree.tree_leaves(old), _tree.tree_leaves(new)):
    d = o != n
    if d.ndim > 2:
      d = d.reshape(d.shape[0], d.shape[1], -1).any(dim=-1)
    out = d if out is None else out | d
  return out


@dataclasses.dataclass(frozen=True)
class GraphProgram:
  """A GraphMat vertex program; the fields mean what they mean in
  :class:`repro.core.vertex_program.GraphProgram`, plus ``process_op``
  (see the module docstring).  Give ``process_message`` or
  ``process_op``, not both."""

  process_message: Optional[Callable[[PyTree, torch.Tensor, PyTree],
                                     PyTree]] = None
  reduce_kind: str = "add"
  reduce: Optional[Callable[[PyTree, PyTree], PyTree]] = None
  reduce_identity: Optional[PyTree] = None
  send_message: Callable[[PyTree], PyTree] = lambda p: p
  apply: Callable[[PyTree, PyTree], PyTree] = lambda red, old: red
  activate: Callable[[PyTree, PyTree], torch.Tensor] = _default_activate
  process_reads_dst: bool = True
  needs_recv: bool = True
  num_message_dims: int = 0
  inert_message: Optional[PyTree] = None
  lanewise: bool = False
  name: str = "graph_program"
  process_op: Optional[str] = None

  def __post_init__(self):
    if self.reduce_kind not in sr.REDUCE_KINDS:
      raise ValueError(
          f"reduce_kind={self.reduce_kind!r} not in {sr.REDUCE_KINDS}")
    if self.reduce_kind == "generic" and self.reduce is None:
      raise ValueError("generic reduce_kind requires an explicit `reduce`")
    if self.process_op is None:
      if self.process_message is None:
        raise ValueError("give process_message or process_op")
      return
    form = PROCESS_FORMS.get(self.process_op)
    if form is None:
      raise ValueError(
          f"process_op={self.process_op!r} not in {PROCESS_OPS}")
    # dataclasses.replace passes the derived form back in; anything else
    # would be a second, unchecked definition of the per-edge function.
    if self.process_message not in (None, form):
      raise ValueError("give process_message or process_op, not both")
    object.__setattr__(self, "process_message", form)
    object.__setattr__(self, "process_reads_dst",
                       self.process_op in DST_FORMS)

  def reduce_fn(self) -> Callable[[PyTree, PyTree], PyTree]:
    if self.reduce is not None:
      return self.reduce
    leaf = sr.reduce_fn_for(self.reduce_kind)
    return lambda a, b: _tree.tree_map(leaf, a, b)

  def identity_like(self, result_tree: PyTree) -> PyTree:
    """Pytree of identity-filled tensors shaped like ``result_tree``."""
    if self.reduce_identity is not None:
      return _tree.tree_map(lambda x, i: torch.full_like(x, i), result_tree,
                            self.reduce_identity)
    return _tree.tree_map(
        lambda x: torch.full_like(x, sr._identity_for(self.reduce_kind,
                                                      x.dtype)),
        result_tree)


def program_from_semiring(s: sr.Semiring, name: str = "") -> GraphProgram:
  """Lift a classical semiring into the vertex-program API."""
  return GraphProgram(
      process_message=(None if s.process_op is not None
                       else lambda m, e, d: s.mul(m, e)),
      reduce_kind=s.reduce_kind,
      process_reads_dst=False,
      name=name or f"semiring:{s.name}",
      process_op=s.process_op,
  )
