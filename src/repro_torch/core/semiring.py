"""Semirings for generalized sparse matrix operations (PyTorch port).

Port of :mod:`repro.core.semiring`: a :class:`Semiring` value object plus
the standard instances.  ``reduce`` must be associative and commutative,
which is what lets a backend reduce edges in any order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

# Reduction kinds: the first five have scatter fast paths; ``generic`` (a
# program's own ``reduce``) runs as spmv._axis_tree_reduce /
# spmv._segment_reduce_scan.
REDUCE_KINDS = ("add", "min", "max", "any", "all", "generic")


def _identity_for(kind: str, dtype: torch.dtype) -> Any:
  """The reduce identity for ``kind`` as a Python scalar of ``dtype``'s kind."""
  if kind == "add":
    return 0
  if kind == "min":
    if dtype.is_floating_point:
      return float("inf")
    return torch.iinfo(dtype).max
  if kind == "max":
    if dtype.is_floating_point:
      return float("-inf")
    return torch.iinfo(dtype).min
  if kind == "any":
    return False
  if kind == "all":
    return True
  raise ValueError(f"no default identity for reduce kind {kind!r}")


def reduce_fn_for(kind: str) -> Callable[[torch.Tensor, torch.Tensor],
                                          torch.Tensor]:
  return {
      "add": torch.add,
      "min": torch.minimum,
      "max": torch.maximum,
      "any": torch.logical_or,
      "all": torch.logical_and,
  }[kind]


@dataclasses.dataclass(frozen=True)
class Semiring:
  """An (add, mul) pair with identities, in GraphMat's generalized sense.

  ``process_op`` names the per-edge form of ``mul`` that the CUDA ELL
  kernel implements (see :class:`repro_torch.core.vertex_program.
  GraphProgram`), or None when the kernel has no such form.
  """

  name: str
  add: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
  mul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
  reduce_kind: str
  process_op: Any = None

  def identity(self, dtype: torch.dtype) -> Any:
    return _identity_for(self.reduce_kind, dtype)


PLUS_TIMES = Semiring("plus_times", torch.add, torch.mul, "add",
                      "msg_times_edge")
MIN_PLUS = Semiring("min_plus", torch.minimum, torch.add, "min",
                    "msg_plus_edge")
MAX_TIMES = Semiring("max_times", torch.maximum, torch.mul, "max",
                     "msg_times_edge")
OR_AND = Semiring("or_and", torch.logical_or, torch.logical_and, "any")
MIN_FIRST = Semiring("min_first", torch.minimum, lambda m, e: m, "min", "msg")
