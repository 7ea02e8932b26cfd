"""Per-rank cost of one call of a step: the port of
:mod:`repro.analysis.hlo_cost`.

The reference parses the optimized HLO and multiplies ``while`` bodies by
their trip counts.  The port counts ops as they are dispatched, under a
``TorchDispatchMode`` (:class:`CostMode`), on whatever tensors the step runs
on — real ones on a card, or fake ones in a dry run
(:mod:`repro_torch.launch.dryrun`).  Eager dispatch sees every layer of the
model's Python loop, so there is no trip-count logic.  On DTensors the mode
lets DTensor run first, so it counts what each rank runs: the local ops on
its shards, and the collectives DTensor issues; the ops DTensor runs on
fake tensors of the global shapes, to propagate shapes, are not counted.

  * ``flops``: products (``mm``, ``bmm``, ``addmm``, ``baddbmm``) at
    2 · |out| · |contracted|; every other pointwise or reducing op ≈ |out|,
    as the reference approximates (copies and fills count none); transcendental ops (exp, log, tanh,
    sin, cos, sqrt, rsqrt, pow, sigmoid, expm1, log1p, erf) count in
    ``transcendentals`` instead.
  * ``bytes``: the bytes of every tensor operand and output of each op
    dispatched, views and allocations (``empty*``) excepted (they move
    nothing).  Eager dispatch has no
    fusion boundary, so this is larger than XLA's count at fusion
    boundaries: an intermediate that a fusion keeps on chip is counted here
    as written and read again.  An in-place index write (``index_copy_``,
    ``index_put_``, ``index_add_``, ``scatter_``, ``scatter_add_``) counts
    the region written (3 × its source: read and write of the destination
    region, read of the source) plus its indices, not the whole buffer, as
    the reference prices a dynamic-update-slice.
  * ``peak_bytes``: the peak of the bytes that the ops' results hold while
    they live (views and in-place results excepted): the step's own
    memory, beyond what its arguments held.
  * ``collectives``: per ``"kind|group size"`` the kind (the reference's
    names: ``all-reduce``, ``all-gather``, ``reduce-scatter``,
    ``all-to-all``, ``collective-permute``), the group size, the count and
    the output bytes; functional collectives (DTensor's) and c10d's
    in-place ones (``torch.distributed.all_reduce`` and its siblings)
    alike.
"""

from __future__ import annotations

import functools
import threading
import weakref
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

_PRODUCTS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
             aten.baddbmm.default}
_TRANSCENDENTAL = {"exp", "exp_", "log", "log_", "tanh", "tanh_", "sin",
                   "cos", "sqrt", "sqrt_", "rsqrt", "rsqrt_", "pow", "pow_",
                   "sigmoid", "sigmoid_", "expm1", "log1p", "erf", "exp2",
                   "softplus", "silu", "silu_", "logsumexp"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "cumsum",
               "argmax", "argmin", "all", "any", "var", "std", "norm",
               "linalg_vector_norm", "_softmax", "_log_softmax"}
_COPIES = {"clone", "_to_copy", "copy", "copy_", "lift_fresh", "fill",
           "fill_", "zero_", "masked_fill", "masked_fill_"}
_INDEX_WRITES = {"index_copy_", "index_put_", "index_add_", "scatter_",
                 "scatter_add_"}
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
    # c10d's in-place ops, which ``torch.distributed.all_reduce`` and its
    # siblings dispatch (the 2-D runner's collectives).
    "allreduce_": "all-reduce", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}


def _nbytes(t: torch.Tensor) -> int:
  return t.numel() * t.element_size()


def _tensors(x):
  return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _group_size(args) -> int:
  """The size of the process group of a collective's arguments: a c10d
  op's ``ProcessGroup`` object, or a functional collective's group name
  (its last string argument)."""
  import torch.distributed as dist
  from torch.distributed.distributed_c10d import _resolve_process_group
  for a in args:
    if isinstance(a, torch.ScriptObject) and \
        a._type().qualified_name().endswith(".ProcessGroup"):
      return dist.ProcessGroup.unbox(a).size()
  names = [a for a in args if isinstance(a, str)]
  if not names:
    return 0
  try:
    return _resolve_process_group(names[-1]).size()
  except (RuntimeError, ValueError, KeyError):
    return 0


def product_flops(func, args, out) -> float:
  """2 · |out| · |contracted| of a product op."""
  a = args[1] if func in (aten.addmm.default, aten.baddbmm.default) else args[0]
  return 2.0 * out.numel() * a.shape[-1]


_PROPAGATING = threading.local()


def _quiet(fn):
  """``fn`` with :data:`_PROPAGATING` set while it runs."""
  @functools.wraps(fn)
  def run(*args, **kwargs):
    prev = getattr(_PROPAGATING, "on", False)
    _PROPAGATING.on = True
    try:
      return fn(*args, **kwargs)
    finally:
      _PROPAGATING.on = prev
  run.quiet = True
  return run


def _mark_shape_propagation() -> None:
  """Mark the ops of DTensor's shape propagation
  (``ShardingPropagator._propagate_tensor_meta_non_cached``, which runs
  each op once on fake tensors of the global shapes) so that
  :class:`CostMode` leaves them out.  A private method of DTensor: raise if
  this torch lacks it rather than count global shapes."""
  from torch.distributed.tensor._sharding_prop import ShardingPropagator
  name = "_propagate_tensor_meta_non_cached"
  fn = getattr(ShardingPropagator, name, None)
  if fn is None:
    raise RuntimeError(f"ShardingPropagator.{name} is missing: CostMode "
                       "cannot tell DTensor's shape propagation from work")
  if not getattr(fn, "quiet", False):
    setattr(ShardingPropagator, name, _quiet(fn))


class CostMode(TorchDispatchMode):
  """Counts flops, bytes, transcendentals and collectives of the ops run
  under it (see the module docstring).  :meth:`result` returns them as
  ``hlo_cost.analyze`` does."""

  def __init__(self):
    super().__init__()
    _mark_shape_propagation()
    self.flops = 0.0
    self.product_flops = 0.0
    self.bytes = 0.0
    self.transcendentals = 0.0
    self.collectives: Dict[str, Dict[str, Any]] = {}
    self.live_bytes = 0
    self.peak_bytes = 0

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    # DTensor first: it turns the op into local ops and collectives, which
    # come back here with the shards' shapes.
    if any(issubclass(t, DTensor) for t in types):
      return NotImplemented
    out = func(*args, **kwargs)
    # DTensor's own shape propagation runs the op on fake tensors of the
    # global shapes: not work of the rank.
    if not getattr(_PROPAGATING, "on", False):
      self._count(func, args, kwargs, out)
      self._track(func, args, _tensors(out))
    return out

  def _track(self, func, args, outs) -> None:
    """Live bytes of the tensors ops make (views and in-place results
    excepted), freed when they are; ``peak_bytes`` is their peak."""
    if func.is_view or func.namespace == "prim":
      return
    ins = {id(t) for t in _tensors(args)}
    for t in outs:
      if id(t) in ins:
        continue
      n = _nbytes(t)
      self.live_bytes += n
      self.peak_bytes = max(self.peak_bytes, self.live_bytes)
      weakref.finalize(t, self._free, n)

  def _free(self, n: int) -> None:
    self.live_bytes -= n

  def _count(self, func, args, kwargs, out) -> None:
    name = func.overloadpacket.__name__
    if func.namespace == "_c10d_functional" or func.namespace == "c10d":
      kind = _COLLECTIVES.get(name)
      if kind is not None:
        outs = _tensors(out)
        gsize = _group_size(args)
        rec = self.collectives.setdefault(
            f"{kind}|{gsize}", {"kind": kind, "group_size": gsize,
                                "bytes": 0.0, "count": 0.0})
        rec["bytes"] += sum(_nbytes(t) for t in outs)
        rec["count"] += 1
      return
    outs = _tensors(out)
    n_out = sum(t.numel() for t in outs)
    if func in _PRODUCTS:
      f = product_flops(func, args, outs[0])
      self.flops += f
      self.product_flops += f
    elif name in _TRANSCENDENTAL:
      self.transcendentals += n_out
    elif name in _REDUCTIONS or (torch.Tag.pointwise in func.tags
                                 and name not in _COPIES):
      self.flops += n_out
    if func.is_view or func.namespace == "prim" or name.startswith("empty"):
      return
    ins = _tensors((args, kwargs))
    if name in _INDEX_WRITES:
      # Source (the last tensor operand) written into a region of the
      # destination: read + write of the region, read of the source, and
      # the indices.
      src = ins[-1]
      idx = sum(_nbytes(t) for t in ins[1:-1])
      self.bytes += 3.0 * _nbytes(src) + idx
      return
    self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)

  def result(self) -> Dict[str, Any]:
    return {"flops": self.flops, "product_flops": self.product_flops,
            "bytes": self.bytes, "transcendentals": self.transcendentals,
            "collectives": {k: dict(v) for k, v in self.collectives.items()},
            "peak_bytes": self.peak_bytes}


def analyze(fn, *args, **kwargs) -> Dict[str, Any]:
  """Run ``fn(*args, **kwargs)`` once under :class:`CostMode`; returns its
  counts (``flops``, ``product_flops``, ``bytes``, ``transcendentals``,
  ``collectives``) and ``out``, what ``fn`` returned."""
  with CostMode() as mode:
    out = fn(*args, **kwargs)
  res = mode.result()
  res["out"] = out
  return res


def collective_bytes(collectives: Dict[str, Dict[str, Any]]) -> float:
  return float(sum(v["bytes"] for v in collectives.values()))

