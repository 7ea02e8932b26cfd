"""A vertex program's ``process_message``, traced into the expression the
CUDA ELL kernel compiles.

The reference's kernel is a template over the user's per-edge function:
``ell_spmv_pallas`` traces ``process`` inline into its body
(``src/repro/kernels/ell_spmv.py:127``), probes the result's width and
dtype (``:138-145``), and ``kernels/ops.py`` hands it the program's own
``process_message``.  The port does the same in three steps:

1. :func:`trace` runs the callable under ``make_fx`` on fake tensors at the
   call's ranks, lanes and dtypes (scalar programs ``m [E]``, ``e [E]``,
   ``d [E]``; lane programs ``m [E, K]``, ``e [E, 1]``, ``d [E, Kd]``) and
   reads the flat aten graph into a :class:`ProcessExpr`: which of ``m``,
   ``e`` and ``d`` it reads, a list of nodes, each with its own dtype,
   constants kept as exact bit patterns, and the result's dtype and width
   ``K_out``.
2. :meth:`ProcessExpr.functor_source` writes the expression as a CUDA
   functor for the kernel's body (``csrc/ell_spmv_body.cuh``): a per-lane
   ``apply(m, e, d)`` for a lanewise process, or, for one that mixes the
   lane axis (:attr:`ProcessExpr.lanes`), an ``apply`` over a row's whole
   K-vector, spread over a team of threads (the lane-vector grid).
3. ``kernels/ell_spmv.py`` builds the functor's instance at its first
   launch, unless the expression equals one of the five shipped forms node
   for node (:attr:`ProcessExpr.shipped`), whose instances ship compiled.

What the kernel takes, and so what a trace accepts: the dtypes the
reference's kernel computes with x64 off (``KINDS``: float32, float16,
bfloat16, int32, int16, int8, uint8), mixed as torch promotes them, and a
float64 message passed through unchanged (the process ``m`` itself, for
the add reduce alone: GAP's betweenness centrality counts its shortest
paths in double, ``algos/bc.py``); the
elementwise ops ``add``, ``sub`` (and ``rsub``), ``mul``, ``div``, ``neg``,
``abs``, ``reciprocal``, ``minimum``, ``maximum``, ``clamp``, ``where``,
the six comparisons, logical and bitwise and / or / xor / not on booleans,
``exp``, ``log``, ``sqrt``, ``rsqrt`` and casts among those dtypes and
bool; and, on the lane axis of a ``[E, K]`` message, the reductions
``sum``, ``mean``, ``amax``, ``amin`` (and ``max.dim`` / ``min.dim``
values) with and without ``keepdim``, constant ``select`` and width-1
``slice``, and ``unsqueeze`` / ``squeeze`` / ``expand`` / ``view`` between
``[E]``, ``[E, 1]`` and ``[E, K]``.  The result is ``[E, K]`` (``K_out =
K``), ``[E, 1]`` or ``[E]`` (``K_out = 1``).  Python scalars and 0-d
tensors are constants.  Anything else is refused with a reason
(:class:`Refused`): a trace that fails (data-dependent control flow), an
op outside that list (another reduction or index across the lane axis
among them), a captured tensor that is not 0-d (the reference's kernel
refuses it too: "captures constants"), an int64 value, a float64 value
anywhere but in that pass-through (an op that computes in float64, reads
float64 edge values or properties, or casts to or from it: the reference
computes in neither), a float64 message under a min or max reduce
(:func:`for_program`), a bool result, a destination property of a
width other than 1 or K, a value of another width.  A program whose
``process_reads_dst`` is False gets ``d = 0``, as the reference's kernel
gets a zero ``dprop`` (``src/repro/kernels/ops.py:53``).

Arithmetic follows eager CUDA op by op.  An arithmetic op computes in its
result's opmath type (float for the float dtypes, int for the integer
ones), its tensor operands loaded straight into that type, and rounds to
the result dtype after the op (float16 and bfloat16 to nearest even; the
narrow integers wrap); a comparison casts its operands to their common
dtype and compares; ``where``, ``minimum`` and ``maximum`` cast theirs to
the result dtype.  Constants in arithmetic, comparisons and ``clamp`` are
taken in the opmath type (float32 for floats); in ``where``, ``minimum``
and ``maximum`` in the result dtype.  A division by a constant is a product
with its float32 reciprocal, as eager CUDA computes it (the CPU divides).
A lane reduction sums, or takes the max or min, in the opmath type and
rounds once; ``mean`` is that sum times the float32 ``1 / K``.
:meth:`ProcessExpr.evaluate` runs the expression with torch ops, which is
how the tests hold it to the callable.

Traces are cached per (callable, dtypes, scalar or lane form, K, Kd = 1 or
not, ``process_reads_dst``), so the per-superstep eligibility checks of
the ``cuda_ell`` backend pay a dictionary lookup; a closure's values are
read at the first trace.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import logging
import operator
import threading
import weakref
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

# The sizes of the fake tensors a trace runs on: E edges (distinct from the
# K lanes, so that a value of the wrong width shows in its shape), and the
# lanes of a lane-form trace whose K is not given.
_EDGES, _LANES = 4, 3
# The widest message whose lanes a process may mix: the lane-vector grid
# spreads a message's K lanes over a team of at most 32 threads.
MAX_LANES = 256

KINDS = {torch.float32: "f32", torch.float16: "f16", torch.bfloat16: "bf16",
         torch.int32: "i32", torch.int16: "i16", torch.int8: "i8",
         torch.uint8: "u8", torch.float64: "f64"}
# The dtypes the shipped library is compiled for (all operands alike).
SHIPPED_DTYPES = (torch.float32, torch.float16, torch.int32)
_TORCH = {kind: dtype for dtype, kind in KINDS.items()} | {"bool": torch.bool}
_FLOAT = ("f32", "f16", "bf16")
_BITS = {"f32": torch.int32, "f16": torch.int16, "bf16": torch.int16,
         "i32": torch.int32, "i16": torch.int16, "i8": torch.int8,
         "u8": torch.uint8}
_WIDTH = {"f32": 32, "f16": 16, "bf16": 16, "i32": 32, "i16": 16, "i8": 8,
          "u8": 8}
CTYPES = {"f32": "float", "f16": "__half", "bf16": "__nv_bfloat16",
          "i32": "int", "i16": "int16_t", "i8": "int8_t", "u8": "uint8_t",
          "f64": "double"}

_BINARY = {"add": "add", "sub": "sub", "mul": "mul", "div": "div",
           "minimum": "min", "maximum": "max"}
_COMPARE = ("lt", "le", "gt", "ge", "eq", "ne")
_LOGICAL = {"logical_and": "and", "logical_or": "or", "logical_xor": "xor",
            "bitwise_and": "and", "bitwise_or": "or", "bitwise_xor": "xor"}
_NOT = ("logical_not", "bitwise_not")
_UNARY = ("neg", "abs", "reciprocal", "exp", "log", "sqrt", "rsqrt")
_IDENTITY = ("lift_fresh_copy", "lift_fresh", "clone", "alias", "detach")
# Reductions over the lane axis the kernel takes, by aten name.
_LANE_REDUCE = {"sum": "sum", "mean": "mean", "amax": "max", "amin": "min",
                "max": "max", "min": "min"}
# Ops that only move values between [E], [E, 1] and [E, K].
_RESHAPE = ("unsqueeze", "squeeze", "view", "reshape", "_unsafe_view",
            "expand", "slice", "select")
_REDUCING = frozenset((
    "sum", "mean", "prod", "amax", "amin", "max", "min", "any", "all",
    "cumsum", "cumprod", "cummax", "cummin", "logsumexp", "_softmax",
    "_log_softmax", "var", "std", "var_mean", "std_mean", "norm",
    "linalg_vector_norm", "argmax", "argmin", "sort", "topk", "nansum",
    "median", "mode"))
_INDEXING = frozenset((
    "slice", "select", "index", "index_select", "gather", "flip", "roll",
    "cat", "stack", "expand", "view", "reshape", "_unsafe_view", "permute",
    "transpose", "t", "unsqueeze", "squeeze", "narrow", "split",
    "split_with_sizes", "chunk", "repeat", "tile", "unbind", "diagonal",
    "scatter", "scatter_add", "index_put", "index_add", "as_strided",
    "constant_pad_nd", "unfold", "movedim"))

Ref = Tuple  # ("m",) | ("e",) | ("d",) | ("v", i) | ("c", kind, bits)
# (op, result kind, shape "vec" | "one" | None, (ref, ...), attribute)
Node = Tuple


@dataclasses.dataclass(frozen=True)
class Refused:
  """Why the kernel cannot take a process."""

  reason: str


@dataclasses.dataclass(frozen=True)
class _Const:
  """A constant before its use decides its type: a Python number, or the
  value of a 0-d tensor of ``dtype`` (exact in it)."""

  value: Any
  dtype: Optional[torch.dtype] = None


class _Refuse(Exception):
  pass


def _unsupported(dtype, what: str) -> _Refuse:
  return _Refuse(f"{what} {dtype}; the kernel computes in float32, float16, "
                 "bfloat16, int32, int16, int8 and uint8, as the reference "
                 "does with x64 off (no int64 or float64; a float64 message "
                 "only passes through unchanged)")


def _const_ref(c: _Const, kind: str) -> Ref:
  """The constant as a literal of ``kind`` (its exact bit pattern)."""
  value = c.value
  if kind == "bool":
    return ("c", "bool", int(bool(value)))
  if kind not in _FLOAT:
    if isinstance(value, float) or (c.dtype is not None
                                    and c.dtype.is_floating_point):
      raise _Refuse(f"uses the float constant {value!r} in an integer op")
    value = int(value)
    info = torch.iinfo(_TORCH[kind])
    if not info.min <= value <= info.max:
      raise _Refuse(f"uses the constant {value} outside {_TORCH[kind]}")
  t = torch.tensor(value, dtype=_TORCH[kind])
  bits = int(t.view(_BITS[kind]).item()) & ((1 << _WIDTH[kind]) - 1)
  return ("c", kind, bits)


def const_value(ref: Ref):
  """A constant ref's value as a Python number."""
  _, kind, bits = ref
  if kind == "bool":
    return bool(bits)
  width = _WIDTH[kind]
  signed = bits - (1 << width) if (kind != "u8"
                                   and bits >= 1 << (width - 1)) else bits
  return torch.tensor(signed, dtype=_BITS[kind]).view(_TORCH[kind]).item()


def _opmath(kind: str) -> str:
  """The kind an op of result ``kind`` computes in (float32 for floats)."""
  return "f32" if kind in _FLOAT else kind


@dataclasses.dataclass(frozen=True)
class ProcessExpr:
  """A traced process: ``nodes`` in order, ``out`` the result.

  ``dtype`` is the message's; ``edge_dtype`` and ``dst_dtype`` those of the
  edge value and the destination property where the process reads them
  (else None); ``out_dtype`` the result's.  A process that mixes the lane
  axis of a ``[E, K]`` message has ``lanes = K`` (its functor takes the
  whole vector), ``k_out`` 1 or K and ``dst_lanes`` the destination
  property's width (1 or K); a lanewise one has None in all three.
  ``squeezed``: the result is ``[E]``, with no lane axis.  Two expressions
  are equal when these and the nodes are; the callable, the form and the
  shipped form it equals are carried beside them.
  """

  dtype: torch.dtype
  nodes: Tuple[Node, ...]
  out: Ref
  edge_dtype: Optional[torch.dtype]
  dst_dtype: Optional[torch.dtype]
  out_dtype: torch.dtype
  lanes: Optional[int] = None
  k_out: Optional[int] = None
  dst_lanes: Optional[int] = None
  fn: Callable = dataclasses.field(default=None, compare=False, repr=False)
  lane: bool = dataclasses.field(default=False, compare=False)
  squeezed: bool = dataclasses.field(default=False, compare=False)
  shipped: Optional[str] = dataclasses.field(default=None, compare=False)

  def _reads(self, name: str) -> bool:
    return self.out == (name,) or any(
        (name,) in node[3] for node in self.nodes)

  @functools.cached_property
  def reads_edge(self) -> bool:
    return self._reads("e")

  @functools.cached_property
  def reads_dst(self) -> bool:
    return self._reads("d")

  @property
  def lane_mixing(self) -> bool:
    """Whether the functor takes a row's whole lane vector."""
    return self.lanes is not None

  @property
  def uniform(self) -> bool:
    """One dtype for everything the process reads, computes and returns."""
    kind = KINDS[self.dtype]
    return (all(t in (None, self.dtype) for t in (self.edge_dtype,
                                                   self.dst_dtype))
            and self.out_dtype == self.dtype
            and all(node[1] in (kind, "bool") for node in self.nodes))

  @functools.cached_property
  def digest(self) -> str:
    """A hash of the dtypes, widths, nodes and output (the build cache's
    key)."""
    kinds = tuple(None if t is None else KINDS[t] for t in (
        self.dtype, self.edge_dtype, self.dst_dtype, self.out_dtype))
    key = (kinds, self.nodes, self.out, self.lanes, self.k_out,
           self.dst_lanes)
    return hashlib.sha1(repr(key).encode()).hexdigest()[:12]

  @functools.cached_property
  def lane_layout(self) -> Tuple[int, int, int, int]:
    """A lane-mixing process's :func:`lane_layout` ``(T, V, W, U)``."""
    return lane_layout(self.lanes, torch.empty((), dtype=self.dtype
                                              ).element_size())

  @property
  def name(self) -> str:
    """The launch counter's name of the instance that runs it."""
    return self.shipped or f"traced_{self.digest[:8]}"

  def plain(self, m: torch.Tensor, e: torch.Tensor, d: torch.Tensor
            ) -> torch.Tensor:
    """The callable itself, as ``ell_spmv_ref``'s ``process`` (``m [...,
    K]``, ``e [...]``, ``d [..., Kd]``): at the ranks it was traced at,
    giving ``[..., K_out]``."""
    if self.lane:
      r = self.fn(m, e[..., None], d)
      return r[..., None] if self.squeezed else r
    return self.fn(m[..., 0], e, d[..., 0])[..., None]

  def evaluate(self, m: torch.Tensor, e: torch.Tensor, d: torch.Tensor
               ) -> torch.Tensor:
    """The expression in torch ops, in the callable's broadcasting form
    (a lane form's per-edge values kept with a unit lane axis)."""
    env = {("m",): m, ("e",): e, ("d",): d}
    values = []
    dev = m.device

    def get(ref, as_tensor=False):
      if ref[0] == "v":
        return values[ref[1]]
      if ref[0] == "c":
        value = const_value(ref)
        if not as_tensor:
          return value
        return torch.tensor(value, dtype=_TORCH[ref[1]], device=dev)
      return env[ref]

    for op, kind, _, args, attr in self.nodes:
      if op in ("min", "max"):
        a, b = (get(r, as_tensor=True) for r in args)
        v = torch.minimum(a, b) if op == "min" else torch.maximum(a, b)
      elif op == "div" and args[0][0] == "c":
        v = torch.div(get(args[0], as_tensor=True), get(args[1]))
      elif op in _EVAL_BINARY:
        v = _EVAL_BINARY[op](get(args[0]), get(args[1]))
      elif op == "where":
        v = torch.where(get(args[0], as_tensor=True), get(args[1]),
                        get(args[2]))
      elif op == "clamp":
        lo, hi = (None if r == ("none",) else get(r) for r in args[1:])
        v = torch.clamp(get(args[0]), lo, hi)
      elif op == "not":
        v = torch.logical_not(get(args[0]))
      elif op == "cast":
        v = get(args[0]).to(_TORCH[kind])
      elif op == "lane_sum":
        v = get(args[0]).sum(-1, keepdim=True, dtype=_TORCH[kind])
      elif op == "lane_mean":
        v = get(args[0]).to(_TORCH[kind]).mean(-1, keepdim=True)
      elif op == "lane_max":
        v = get(args[0]).amax(-1, keepdim=True)
      elif op == "lane_min":
        v = get(args[0]).amin(-1, keepdim=True)
      elif op == "select":
        v = get(args[0])[..., attr:attr + 1]
      elif op == "bcast":
        x = get(args[0])
        v = x.expand(*x.shape[:-1], self.lanes)
      else:
        v = _EVAL_UNARY[op](get(args[0]))
      values.append(v)
    out = get(self.out, as_tensor=True)
    return out[..., 0] if self.squeezed else out

  def functor_source(self, name: str = "TracedProcess") -> str:
    """The expression as a CUDA functor for ``csrc/ell_spmv_body.cuh``."""
    return _emit_lanes(self, name) if self.lane_mixing else _emit(self, name)


_EVAL_BINARY = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
    "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
    "and": torch.logical_and, "or": torch.logical_or,
    "xor": torch.logical_xor}
_EVAL_UNARY = {"neg": torch.neg, "abs": torch.abs,
               "reciprocal": torch.reciprocal, "exp": torch.exp,
               "log": torch.log, "sqrt": torch.sqrt, "rsqrt": torch.rsqrt}


class _Builder:
  """Reads an fx graph of aten ops into nodes."""

  def __init__(self, dtypes: Dict[str, torch.dtype], lane: bool, k: int,
               kd: int, edges: int):
    self.dtypes = dtypes  # "m", "e", "d" -> the operand's dtype
    self.lane, self.k, self.kd, self.edges = lane, k, kd, edges
    self.nodes = []
    self.lane_ops = False  # a reduction, select or broadcast on the lanes

  def add(self, op: str, kind: str, shape, *args, attr=None) -> Ref:
    self.nodes.append((op, kind, shape, tuple(args), attr))
    return ("v", len(self.nodes) - 1)

  def kind(self, ref: Ref) -> str:
    if ref[0] == "v":
      return self.nodes[ref[1]][1]
    if ref[0] == "c":
      return ref[1]
    kind = KINDS.get(self.dtypes[ref[0]])
    if kind is None:
      what = {"m": "message", "e": "edge value",
              "d": "destination property"}[ref[0]]
      raise _unsupported(self.dtypes[ref[0]], f"reads the {what} as")
    return kind

  def shape(self, ref: Ref) -> str:
    """"vec" (one value a lane) or "one" (one value an edge)."""
    if ref[0] == "v":
      return self.nodes[ref[1]][2]
    if ref == ("m",):
      return "vec" if self.lane else "one"
    if ref == ("d",):
      return "vec" if self.lane and self.kd == self.k > 1 else "one"
    return "one"

  def shape_of(self, val) -> str:
    """A meta value's shape as "vec" or "one", or a refusal."""
    s, e = tuple(val.shape), self.edges
    if not self.lane:
      if s == (e,):
        return "one"
    elif s == (e, self.k):
      return "vec"
    elif s in ((e, 1), (e,)):
      return "one"
    raise _Refuse(f"gives a value of shape {list(s)} (edges {e}"
                  + (f", lanes {self.k}" if self.lane else "")
                  + "): the kernel takes [E], [E, 1] or [E, K] values")

  def value(self, x, const: str, kind: str) -> Ref:
    """An operand of an op of result ``kind``: a bool ref cast to it, a
    constant as a literal of kind ``const`` (the op's opmath kind, or its
    result's)."""
    if isinstance(x, _Const):
      return _const_ref(x, const)
    if self.kind(x) == "bool":
      return self.add("cast", kind, self.shape(x), x)
    return x

  def boolean(self, x) -> Ref:
    if isinstance(x, _Const):
      if not isinstance(x.value, bool) and x.dtype is not torch.bool:
        raise _Refuse(f"uses {x.value!r} as a boolean")
      return _const_ref(x, "bool")
    if self.kind(x) != "bool":
      raise _Refuse(f"uses a {self.kind(x)} value as a boolean")
    return x


def _op_name(target) -> Tuple[str, str]:
  packet = getattr(target, "overloadpacket", None)
  if packet is None:
    raise _Refuse(f"calls {target!r}, which is not an aten op")
  return packet.__name__, target._overloadname


def _kind_of(dtype: torch.dtype, name: str) -> str:
  """The kind an op computes its result in: no op computes in float64,
  which a trace takes only as a message returned unchanged."""
  if dtype == torch.bool:
    return "bool"
  if KINDS.get(dtype) in (None, "f64"):
    raise _unsupported(dtype, f"computes aten.{name} in")
  return KINDS[dtype]


def _read_graph(gm, b: _Builder, reads_dst: bool, dtype: torch.dtype):
  env: Dict[Any, Any] = {}
  placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
  for node, ref in zip(placeholders, (("m",), ("e",), ("d",))):
    env[node] = ref if (ref != ("d",) or reads_dst) else _Const(0, dtype)
  out = None
  for node in gm.graph.nodes:
    if node.op == "placeholder":
      continue
    if node.op == "get_attr":
      t = getattr(gm, node.target)
      if not isinstance(t, torch.Tensor) or t.dim() != 0:
        shape = list(t.shape) if isinstance(t, torch.Tensor) else type(t)
        raise _Refuse(f"captures a tensor of shape {shape}; only 0-d "
                      "constants are taken")
      env[node] = _Const(t.item(), t.dtype)
      continue
    if node.op == "output":
      out = node.args[0]
      break
    if node.op != "call_function":
      raise _Refuse(f"has a {node.op} node")
    if node.target is operator.getitem:  # a value of max.dim / min.dim
      pair, index = env[node.args[0]], node.args[1]
      if not (isinstance(pair, tuple) and pair[0] == "pair"):
        raise _Refuse("indexes a tuple that is not a lane max or min")
      env[node] = pair[1] if index == 0 else _Refuse(
          "uses the indices of a lane max or min (int64)")
      continue
    name, overload = _op_name(node.target)
    args = []
    for a in node.args:
      if isinstance(a, torch.fx.Node):
        if isinstance(env[a], _Refuse):
          raise env[a]
        args.append(env[a])
      elif isinstance(a, (bool, int, float)) or a is None:
        args.append(a if a is None else _Const(a))
      elif name in _REDUCING or name in _INDEXING:
        args.append(a)  # dims and sizes, read by the op below
      else:
        raise _Refuse(f"passes {a!r} to aten.{name}")
    env[node] = _node(b, name, overload, args, dict(node.kwargs),
                      node.meta.get("val"))
  if not isinstance(out, torch.fx.Node):
    raise _Refuse(f"returns {type(out).__name__}, not one tensor")
  ref = env[out]
  if isinstance(ref, _Refuse):
    raise ref
  if isinstance(ref, _Const):
    raise _Refuse("returns a constant, not a value per edge and lane")
  return ref, out.meta.get("val")


def _lane_dim(b: _Builder, x: Ref, dims, name: str) -> None:
  """Refuse unless ``dims`` names the lane axis of ``x`` alone."""
  dims = list(dims) if isinstance(dims, (list, tuple)) else [dims]
  dims = [d.value if isinstance(d, _Const) else d for d in dims]
  if not b.lane:
    raise _Refuse(f"reduces or indexes across the edge axis (aten.{name}) "
                  "of a scalar-form message")
  if dims not in ([-1], [1]):
    raise _Refuse(f"reduces or indexes over dims {dims} (aten.{name}); "
                  "the kernel takes the lane axis, -1, alone")


def _lane_node(b: _Builder, name: str, overload: str, args, kwargs, val):
  """A reduction, index or reshape on the lane axis."""
  x = args[0]
  if isinstance(x, _Const):
    raise _Refuse(f"computes aten.{name} on a constant")
  if name in _LANE_REDUCE and not (name in ("max", "min")
                                   and overload != "dim"):
    _lane_dim(b, x, args[1] if len(args) > 1 else [], name)
    if kwargs.keys() - {"dtype"}:
      raise _Refuse(f"passes {kwargs} to aten.{name}")
    if b.kind(x) == "bool":
      raise _Refuse(f"reduces booleans across the lanes (aten.{name})")
    tup = name in ("max", "min")
    res = val[0] if tup else val
    kind = _kind_of(res.dtype, name)
    b.shape_of(res)
    if b.shape(x) == "one":  # over a unit lane axis: the value itself
      ref = x if kind == b.kind(x) else b.add("cast", kind, "one", x)
    else:
      b.lane_ops = True
      ref = b.add("lane_" + _LANE_REDUCE[name], kind, "one", x)
    return ("pair", ref) if tup else ref
  if kwargs:
    raise _Refuse(f"passes {kwargs} to aten.{name}")
  if name == "select":
    _lane_dim(b, x, args[1], name)
    if b.shape(x) == "one":
      return x
    index = args[2].value
    b.lane_ops = True
    return b.add("select", b.kind(x), "one", x,
                 attr=index + b.k if index < 0 else index)
  if name == "slice":
    _lane_dim(b, x, args[1] if len(args) > 1 else 0, name)
    width = tuple(val.shape)[-1]
    if b.shape(x) == "one" or width == b.k:
      return x
    step = args[4].value if len(args) > 4 else 1
    start = args[2].value if len(args) > 2 and args[2] is not None else 0
    if width != 1 or step != 1:
      raise _Refuse(f"slices the lane axis to width {width} (aten.slice): "
                    "the kernel takes values of width 1 or K")
    b.lane_ops = True
    return b.add("select", b.kind(x), "one", x,
                 attr=max(start + b.k if start < 0 else start, 0))
  if not b.lane:
    raise _Refuse(f"indexes or reshapes across the edge axis (aten.{name}) "
                  "of a scalar-form message")
  shape = b.shape_of(val)
  if shape == b.shape(x):  # [E] <-> [E, 1], or a no-op
    return x
  if name == "expand" and shape == "vec":
    b.lane_ops = True
    return b.add("bcast", b.kind(x), "vec", x)
  raise _Refuse(f"reshapes the lane axis (aten.{name}) of a "
                f"{b.shape(x)} value to {list(val.shape)}")


def _common(b: _Builder, xs) -> str:
  """The dtype torch computes a comparison of ``xs`` in."""
  def rep(x):
    if isinstance(x, _Const):
      return (x.value if x.dtype is None
              else torch.tensor(x.value, dtype=x.dtype))
    return torch.empty((1,), dtype=_TORCH[b.kind(x)])
  common = torch.result_type(rep(xs[0]), rep(xs[1]))
  return _kind_of(common, "comparison")


def _node(b: _Builder, name: str, overload: str, args, kwargs, val):
  """One aten call as IR (a ref, or a constant for an identity op on one)."""
  if name in _IDENTITY:
    return args[0]
  if name == "scalar_tensor":
    dtype = kwargs.get("dtype") or torch.float32
    return _Const(torch.tensor(args[0].value, dtype=dtype).item(), dtype)
  if name in _LANE_REDUCE and not (name in ("max", "min")
                                   and overload == "other"):
    return _lane_node(b, name, overload, args, kwargs, val)
  if name in _RESHAPE:
    return _lane_node(b, name, overload, args, kwargs, val)
  if name in _REDUCING:
    raise _Refuse(f"reduces across the lane axis (aten.{name}), which the "
                  "kernel does not take")
  if name in _INDEXING:
    raise _Refuse(f"indexes or reshapes across the lane axis (aten.{name})")
  if val is None:
    raise _Refuse(f"aten.{name} has no traced value")
  kind = _kind_of(val.dtype, name)
  alpha = kwargs.pop("alpha", 1)
  if name in ("add", "sub", "rsub") and alpha != 1:
    raise _Refuse(f"passes alpha={alpha} to aten.{name}")
  if name == "_to_copy":
    target = kwargs.pop("dtype", None)
    if kwargs or target is None:
      raise _Refuse(f"casts with {kwargs or 'no dtype'}; only dtype casts "
                    "are taken")
    x = args[0]
    if isinstance(x, _Const):
      return _Const(torch.tensor(x.value, dtype=x.dtype).to(target).item(),
                    target)
    return x if b.kind(x) == kind else b.add("cast", kind, b.shape_of(val),
                                             x)
  if kwargs:
    raise _Refuse(f"passes {kwargs} to aten.{name}")
  if all(isinstance(a, _Const) or a is None for a in args):
    raise _Refuse(f"computes aten.{name} on constants only")
  shape = b.shape_of(val)
  if name in ("max", "min") and overload == "other":
    name = "maximum" if name == "max" else "minimum"
  math = _opmath(kind)
  if name == "rsub":
    return b.add("sub", kind, shape, b.value(args[1], math, kind),
                 b.value(args[0], math, kind))
  if name in _BINARY and len(args) == 2:
    op = _BINARY[name]
    role = kind if op in ("min", "max") else math
    return b.add(op, kind, shape, b.value(args[0], role, kind),
                 b.value(args[1], role, kind))
  if name in _COMPARE and len(args) == 2:
    common = _common(b, args)
    return b.add(name, "bool", shape,
                 *(b.value(x, _opmath(common), common) for x in args),
                 attr=common)
  if name in _LOGICAL and len(args) == 2:
    if kind != "bool":
      raise _Refuse(f"uses aten.{name} on integers")
    return b.add(_LOGICAL[name], "bool", shape, b.boolean(args[0]),
                 b.boolean(args[1]))
  if name in _NOT and len(args) == 1:
    if kind != "bool":
      raise _Refuse(f"uses aten.{name} on integers")
    return b.add("not", "bool", shape, b.boolean(args[0]))
  if name in _UNARY and len(args) == 1:
    return b.add(name, kind, shape, b.value(args[0], math, kind))
  if name in ("clamp", "clamp_min", "clamp_max") and 2 <= len(args) <= 3:
    lo, hi = (args[1], args[2] if len(args) == 3 else None)
    if name == "clamp_max":
      lo, hi = None, args[1]
    bounds = [("none",) if x is None else b.value(x, math, kind)
              for x in (lo, hi)]
    return b.add("clamp", kind, shape, b.value(args[0], math, kind),
                 *bounds)
  if name == "where" and len(args) == 3:
    return b.add("where", kind, shape, b.boolean(args[0]),
                 b.value(args[1], kind, kind), b.value(args[2], kind, kind))
  raise _Refuse(f"uses aten.{name}.{overload}, which is not among the "
                "ops the kernel takes")


def _live(b: _Builder, out: Ref) -> Tuple[Tuple[Node, ...], Ref]:
  """The nodes ``out`` depends on, renumbered in order."""
  used = set()
  stack = [out]
  while stack:
    ref = stack.pop()
    if ref[0] == "v" and ref[1] not in used:
      used.add(ref[1])
      stack.extend(b.nodes[ref[1]][3])
  order = sorted(used)
  new = {old: i for i, old in enumerate(order)}

  def ren(ref):
    return ("v", new[ref[1]]) if ref[0] == "v" else ref

  nodes = tuple((op, kind, shape, tuple(ren(a) for a in args), attr)
                for op, kind, shape, args, attr in (b.nodes[i]
                                                    for i in order))
  return nodes, ren(out)


_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_LOCK = threading.Lock()


def trace(fn: Callable, dtype: torch.dtype, *, lane: bool,
          edge_dtype: Optional[torch.dtype] = None,
          dst_dtype: Optional[torch.dtype] = None, kd: int = 1,
          reads_dst: bool = True, k: Optional[int] = None
          ) -> Union[ProcessExpr, Refused]:
  """``fn(m, e, d)`` as a :class:`ProcessExpr`, or why the kernel cannot
  take it.

  ``dtype`` is the message's; ``edge_dtype`` and ``dst_dtype`` default to
  it; ``lane`` traces the ``[E, K]`` form with a ``[E, Kd]`` destination
  property, else the ``[E]`` form.  ``k`` is the message's lanes (default:
  ``kd`` where that is not 1, else 3); ``kd`` is 1 or K.  ``reads_dst``
  False makes ``d`` the constant 0.
  """
  edge_dtype = edge_dtype or dtype
  dst_dtype = dst_dtype or dtype
  if lane and k is None:
    k = kd if kd != 1 else _LANES
  key = (dtype, edge_dtype, dst_dtype, lane, k if lane else None,
         kd if lane else 1, reads_dst)
  with _LOCK:
    try:
      per_fn = _CACHE.setdefault(fn, {})
    except TypeError:  # not weakly referenceable: traced every call
      per_fn = {}
    hit = per_fn.get(key)
    if hit is None:
      hit = per_fn[key] = _trace(fn, dtype, edge_dtype, dst_dtype, lane,
                                 k if lane else 1, kd if lane else 1,
                                 reads_dst)
  return hit


def _trace(fn, dtype, edge_dtype, dst_dtype, lane, k, kd, reads_dst,
           match: bool = True):
  from torch.fx.experimental.proxy_tensor import make_fx
  if dtype not in KINDS:
    return Refused(str(_unsupported(dtype, "has messages of")))
  if lane and kd not in (1, k):
    return Refused(f"reads a destination property of width {kd} with "
                   f"K = {k} message lanes; the kernel takes Kd = 1 or K")
  edges = _EDGES if k != _EDGES else _EDGES + 1
  m_shape = (edges, k) if lane else (edges,)
  shapes = (m_shape, (edges, 1) if lane else (edges,),
            (edges, kd) if lane else (edges,))
  inputs = [torch.zeros(s, dtype=t) for s, t in zip(
      shapes, (dtype, edge_dtype, dst_dtype))]
  # A failed op logs its traceback at ERROR before it raises; the refusal
  # below carries the reason.
  fake_log = logging.getLogger("torch._subclasses.fake_tensor")
  level = fake_log.level
  fake_log.setLevel(logging.CRITICAL)
  try:
    with torch.inference_mode(False):
      # Tensors the callable captures become constants of the graph.
      gm = make_fx(fn, tracing_mode="fake",
                   _allow_non_fake_inputs=True)(*inputs)
  except Exception as exc:  # the user's code: any failure is a refusal
    first = (str(exc).strip().splitlines() or [""])[0][:160]
    return Refused(f"cannot be traced ({type(exc).__name__}: {first}); "
                   "data-dependent control flow is not taken")
  finally:
    fake_log.setLevel(level)
  b = _Builder({"m": dtype, "e": edge_dtype, "d": dst_dtype}, lane, k, kd,
               edges)
  try:
    out, val = _read_graph(gm, b, reads_dst, dtype)
    if val is None:
      raise _Refuse("returns a value with no traced shape")
    passed = not b.nodes and out == ("m",)  # the message, unchanged
    out_kind = (b.kind(out) if passed
                else _kind_of(val.dtype, "its result"))
    if out_kind == "bool":
      raise _Refuse("returns torch.bool; the kernel reduces values, as the "
                    "reference's does (it refuses a bool result)")
    b.kind(out)
    shape = tuple(val.shape)
    if shape == m_shape:
      k_out = k
    elif lane and shape in ((edges, 1), (edges,)):
      k_out = 1
    else:
      raise _Refuse(f"returns shape {list(shape)} for messages "
                    f"{list(m_shape)} (the kernel takes K_out = 1 or K)")
    mixing = lane and (b.lane_ops or k_out != k)
    if out_kind != b.kind(out):
      out = b.add("cast", out_kind, b.shape(out), out)
    nodes, out = _live(b, out)
    if not mixing:  # per-lane values: the node's width does not matter
      nodes = tuple((op, kind, None, args, attr)
                    for op, kind, _, args, attr in nodes)
    expr = ProcessExpr(dtype, nodes, out, None, None, _TORCH[out_kind],
                       fn=fn, lane=lane, squeezed=lane and len(shape) == 1)
    for role in ("e", "d"):
      if expr._reads(role):
        b.kind((role,))  # refuses a dtype the kernel does not take
    if not passed and "f64" in [b.kind((r,)) for r in ("m", "e", "d")
                                if expr._reads(r)]:
      raise _unsupported(torch.float64, "computes with values of")
  except _Refuse as exc:
    return Refused(str(exc))
  expr = dataclasses.replace(
      expr, edge_dtype=edge_dtype if expr.reads_edge else None,
      dst_dtype=dst_dtype if expr.reads_dst else None,
      lanes=k if mixing else None, k_out=k_out if mixing else None,
      dst_lanes=(kd if expr.reads_dst else 1) if mixing else None)
  if match and expr.uniform and dtype in SHIPPED_DTYPES and not mixing:
    for form, other in _shipped_forms(dtype, lane, kd == 1).items():
      if other == expr:
        return dataclasses.replace(expr, shipped=form)
  return expr


@functools.lru_cache(maxsize=None)
def _shipped_forms(dtype: torch.dtype, lane: bool, kd_one: bool
                   ) -> Dict[str, ProcessExpr]:
  """The five forms compiled into the shipped library, traced as a user's
  callable would be (``vertex_program.PROCESS_FORMS``)."""
  from repro_torch.core.vertex_program import DST_FORMS, PROCESS_FORMS
  out = {}
  for form, fn in PROCESS_FORMS.items():
    got = _trace(fn, dtype, dtype, dtype, lane, _LANES if lane else 1,
                 1 if kd_one or not lane else _LANES, form in DST_FORMS,
                 match=False)
    if isinstance(got, ProcessExpr):
      out[form] = dataclasses.replace(got, shipped=form)
  return out


def for_program(program, msg: torch.Tensor, vals: torch.Tensor,
                dprop: Optional[torch.Tensor]
                ) -> Union[str, ProcessExpr, Refused]:
  """What the kernel runs for ``program`` on one call: its ``process_op``
  (a shipped form by name, where the shipped library has the call's
  dtypes), its traced ``process_message``, or why neither.  ``msg`` is the
  single message leaf ([n] or [n, K]); ``dprop`` the single
  destination-property leaf when the program reads it."""
  if program.reduce_kind not in ("add", "min", "max"):
    return Refused(f"its reduce_kind is {program.reduce_kind!r}: the kernel "
                   "reduces by add, min or max (a generic reduce runs on the "
                   "torch backends)")
  if msg.dtype == torch.float64 and program.reduce_kind != "add":
    return Refused(f"has torch.float64 messages under the "
                   f"{program.reduce_kind} reduce: the kernel sums float64 "
                   "messages (the add reduce) and reduces no other way")
  reads_dst = program.process_reads_dst
  dst_dtype = (dprop.dtype if reads_dst and dprop is not None
               else msg.dtype)
  if program.process_op is not None and msg.dtype in SHIPPED_DTYPES and (
      vals.dtype == msg.dtype or program.process_op in (
          "msg", "msg_plus_one")) and dst_dtype == msg.dtype:
    return program.process_op
  lane = msg.ndim == 2
  kd = (dprop.shape[1] if lane and reads_dst and dprop is not None
        and dprop.ndim == 2 else 1)
  expr = trace(program.process_message, msg.dtype, lane=lane,
               k=msg.shape[1] if lane else None, edge_dtype=vals.dtype,
               dst_dtype=dst_dtype, kd=kd, reads_dst=reads_dst)
  if isinstance(expr, ProcessExpr) and (expr.lanes or 0) > MAX_LANES:
    return Refused(f"mixes the lanes of a K = {expr.lanes} message; the "
                   f"kernel's lane-vector grid takes K up to {MAX_LANES}")
  return expr


# ---------------------------------------------------------------------------
# The CUDA functor
# ---------------------------------------------------------------------------

_CMP_OP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
           "ne": "!="}
_LOGIC_OP = {"and": "&&", "or": "||", "xor": "!="}
_ROUND = {"f16": "round_half", "bf16": "round_bf16", "i16": "int16_t",
          "i8": "int8_t", "u8": "uint8_t"}
_LOAD = {"f16": "__half2float", "bf16": "__bfloat162float"}
_STORE = {"f16": "__float2half_rn", "bf16": "__float2bfloat16_rn",
          "i16": "static_cast<int16_t>", "i8": "static_cast<int8_t>",
          "u8": "static_cast<uint8_t>"}


def _compute(kind: str) -> str:
  """The C type a value of ``kind`` is kept in."""
  if kind == "f64":
    return "double"
  return "bool" if kind == "bool" else ("float" if kind in _FLOAT else "int")


def _literal(ref: Ref, compute: str) -> str:
  """A constant in a compute type (float for the float kinds, int for the
  integer ones), by its bit pattern."""
  _, kind, bits = ref
  if kind == "bool":
    return "true" if bits else "false"
  if compute == "int":
    return f"static_cast<int>(0x{int(const_value(ref)) & 0xffffffff:08x}u)"
  if kind != "f32":
    value = torch.tensor(const_value(ref), dtype=_TORCH[kind])
    bits = int(value.float().view(torch.int32).item()) & 0xffffffff
  return f"__uint_as_float(0x{bits:08x}u)"


class _Writer:
  """The C text of each node's value, shared by both functor shapes."""

  def __init__(self, expr: ProcessExpr, lanes: bool):
    self.expr, self.lanes = expr, lanes

  def kind(self, r: Ref) -> str:
    if r[0] == "v":
      return self.expr.nodes[r[1]][1]
    if r[0] == "c":
      return r[1]
    t = {"m": self.expr.dtype, "e": self.expr.edge_dtype,
         "d": self.expr.dst_dtype}[r[0]]
    return KINDS[t]

  def is_vec(self, r: Ref) -> bool:
    if not self.lanes:
      return False
    if r[0] == "v":
      return self.expr.nodes[r[1]][2] == "vec"
    return r == ("m",) or (r == ("d",) and self.expr.dst_lanes > 1)

  def ref(self, r: Ref, compute: str, j: str = "j") -> str:
    """``r`` as an operand computing in ``compute`` (float or int)."""
    if r[0] == "c":
      return _literal(r, compute)
    text = f"v{r[1]}" if r[0] == "v" else r[0]
    if self.is_vec(r):
      text += f"[{j}]"
    if compute == "float" and _compute(self.kind(r)) == "int":
      text = f"static_cast<float>({text})"
    return text

  def common(self, r: Ref, kind: str) -> str:
    """``r`` cast to ``kind`` (a comparison's, ``where``'s, ``min``'s)."""
    compute = _compute(kind)
    text = self.ref(r, compute)
    if (r[0] != "c" and kind in ("f16", "bf16")
        and _compute(self.kind(r)) == "int"):
      text = f"{_ROUND[kind]}({text})"
    return text

  def text(self, op: str, kind: str, args, attr) -> str:
    compute = _compute(kind)
    num = f"Num<{compute}>"

    def rounded(t):
      if kind in ("f16", "bf16"):
        return f"{_ROUND[kind]}({t})"
      if kind in ("i16", "i8", "u8"):
        return f"static_cast<{_ROUND[kind]}>({t})"
      return t

    a = [self.ref(r, compute) for r in args]
    if op in ("add", "sub", "mul"):
      return rounded(f"{num}::{op}({a[0]}, {a[1]})")
    if op in ("min", "max", "where"):
      c = [self.common(r, kind) for r in args[-2:]]
      if op == "where":
        return f"({a[0]} ? {c[0]} : {c[1]})"
      return f"{num}::{op}({c[0]}, {c[1]})"
    if op == "div":
      if args[1][0] == "c":  # a product with the float32 reciprocal
        c = np.float32(const_value(args[1]))
        with np.errstate(divide="ignore", over="ignore"):
          inv = np.float32(1.0) / c
        return rounded(f"{num}::mul({a[0]}, __uint_as_float("
                       f"0x{int(inv.view(np.uint32)):08x}u))")
      return rounded(f"__fdiv_rn({a[0]}, {a[1]})")
    if op == "neg":
      return (rounded(f"{num}::sub(0, {a[0]})") if compute == "int"
              else f"-{a[0]}")
    if op == "abs":
      return (rounded(f"({a[0]} < 0 ? {num}::sub(0, {a[0]}) : {a[0]})")
              if compute == "int" else f"fabsf({a[0]})")
    if op == "reciprocal":
      return rounded(f"__fdiv_rn(1.0f, {a[0]})")
    if op in ("exp", "log"):
      return rounded(f"{op}f({a[0]})")
    if op == "sqrt":
      return rounded(f"__fsqrt_rn({a[0]})")
    if op == "rsqrt":
      return rounded(f"rsqrtf({a[0]})")
    if op in _CMP_OP:
      c = [self.common(r, attr) for r in args]
      return f"({c[0]} {_CMP_OP[op]} {c[1]})"
    if op in _LOGIC_OP:
      return f"({a[0]} {_LOGIC_OP[op]} {a[1]})"
    if op == "not":
      return f"!{a[0]}"
    if op == "cast":
      src = self.kind(args[0])
      if src == "bool":
        return f"({a[0]} ? {num}::one() : {num}::zero())"
      if kind == "bool":
        return f"({self.ref(args[0], _compute(src))} != 0)"
      if compute == "int" and _compute(src) == "float":
        return rounded(f"__float2int_rz({self.ref(args[0], 'float')})")
      return rounded(a[0])
    if op == "clamp":
      x = a[0]
      if args[1] != ("none",):
        x = f"{num}::max({x}, {a[1]})"
      if args[2] != ("none",):
        x = f"{num}::min({x}, {a[2]})"
      if compute == "int":
        return x
      # NaN stays NaN, as in torch.clamp.
      return rounded(f"({a[0]} != {a[0]} ? {a[0]} : {x})")
    raise ValueError(f"no CUDA text for {op}")

  def store(self, r: Ref, kind: str) -> str:
    text = self.ref(r, _compute(kind))
    return f"{_STORE[kind]}({text})" if kind in _STORE else text


def _header(expr: ProcessExpr) -> str:
  kinds = KINDS[expr.dtype]
  if not expr.uniform:
    kinds = " ".join(f"{n} {KINDS[t]}" for n, t in (
        ("m", expr.dtype), ("e", expr.edge_dtype), ("d", expr.dst_dtype),
        ("->", expr.out_dtype)) if t is not None)
  return (f"// {kinds} process traced from "
          f"{getattr(expr.fn, '__qualname__', type(expr.fn).__name__)}")


def _emit(expr: ProcessExpr, name: str) -> str:
  """A lanewise process's functor: ``apply(m, e, d)`` for one lane."""
  w = _Writer(expr, lanes=False)
  lines = []
  for i, (op, kind, _, args, attr) in enumerate(expr.nodes):
    lines.append(f"    const {_compute(kind)} v{i} = "
                 f"{w.text(op, kind, args, attr)};")
  params = []
  for var in ("m", "e", "d"):
    t = {"m": expr.dtype, "e": expr.edge_dtype or expr.dtype,
         "d": expr.dst_dtype or expr.dtype}[var]
    kind, ctype = KINDS[t], CTYPES[KINDS[t]]
    if not expr._reads(var):
      params.append(f"{ctype} /*{var}*/")
    elif kind in _LOAD:
      params.append(f"{ctype} {var}_h")
      lines.insert(0, f"    const float {var} = {_LOAD[kind]}({var}_h);")
    else:
      params.append(f"{ctype} {var}")
  out_kind = KINDS[expr.out_dtype]
  return "\n".join([
      f"{_header(expr)}: {len(expr.nodes)} node(s)",
      f"struct {name} {{",
      f"  static constexpr bool kReadsEdge = "
      f"{'true' if expr.reads_edge else 'false'};",
      f"  static constexpr bool kReadsDst = "
      f"{'true' if expr.reads_dst else 'false'};",
      f"  __device__ __forceinline__ static {CTYPES[out_kind]} apply("
      + ", ".join(params) + ") {",
      *lines,
      f"    return {w.store(expr.out, out_kind)};",
      "  }",
      "};",
      ""])


def lane_layout(k: int, itemsize: int) -> Tuple[int, int, int, int]:
  """``(T, V, W, U)``: how the lane-vector grid spreads a K-lane message of
  ``itemsize``-byte values.  A team of T threads (a power of two up to 32)
  holds one message, V contiguous lanes a thread (lanes ``sub * V + j`` on
  thread ``sub``): 16 bytes of lanes where K allows, more where K is over
  32 of those.  A thread loads its lanes W at a time, the widest load of at
  most 16 bytes that divides both V and K (so that every load is aligned
  in each message row).  A team takes U slots of its row per step: as many
  as keep 64 bytes of message loads in flight a thread, 1 to 4."""
  per_load = 16 // itemsize
  v = max(min(per_load, k), -(-k // 32))
  t = 1
  while t * v < k:
    t *= 2
  w = per_load
  while v % w or k % w:
    w //= 2
  return t, v, w, max(1, min(4, 64 // (v * itemsize)))


_TEAM = {"lane_sum": "team_sum", "lane_mean": "team_sum",
         "lane_max": "team_max", "lane_min": "team_min"}


def _emit_lanes(expr: ProcessExpr, name: str) -> str:
  """A lane-mixing process's functor: ``apply`` over one edge's K lanes,
  spread over a team of T threads (this thread: lanes ``sub * V + j``,
  j < V), giving its lanes of the K_out results."""
  k = expr.lanes
  t, v, w_load, slots = expr.lane_layout
  w = _Writer(expr, lanes=True)
  loop = "#pragma unroll\n    for (int j = 0; j < kVec; ++j) "
  lines = []
  for var, dt in (("m", expr.dtype), ("e", expr.edge_dtype),
                  ("d", expr.dst_dtype)):
    if dt is None:
      continue
    kind = KINDS[dt]
    load = _LOAD.get(kind, "")
    ctype = _compute(kind)
    if var == "e" or (var == "d" and expr.dst_lanes == 1):
      index = "[0]" if var == "d" else ""
      lines.append(f"    const {ctype} {var} = {load}({var}_in{index});")
    else:
      lines += [f"    {ctype} {var}[kVec];",
                f"    {loop}{var}[j] = {load}({var}_in[j]);"]
  for i, (op, kind, shape, args, attr) in enumerate(expr.nodes):
    ctype = _compute(kind)
    if op in _TEAM:
      (x,) = args
      acc = {"lane_sum": f"Num<{ctype}>::zero()",
             "lane_mean": f"Num<{ctype}>::zero()",
             "lane_max": f"Num<{ctype}>::bottom()",
             "lane_min": f"Num<{ctype}>::top()"}[op]
      fold = {"lane_sum": "add", "lane_mean": "add", "lane_max": "max",
              "lane_min": "min"}[op]
      lines += [
          f"    {ctype} v{i} = {acc};",
          f"    {loop}if (sub * kVec + j < kLanes) v{i} = "
          f"Num<{ctype}>::{fold}(v{i}, {w.ref(x, ctype)});",
          f"    v{i} = {_TEAM[op]}<kTeam>(v{i});"]
      if op == "lane_mean":
        inv = np.float32(1.0) / np.float32(k)
        lines.append(f"    v{i} = Num<float>::mul(v{i}, __uint_as_float("
                     f"0x{int(inv.view(np.uint32)):08x}u));")
      if kind in ("f16", "bf16"):
        lines.append(f"    v{i} = {_ROUND[kind]}(v{i});")
    elif op == "select":
      (x,) = args
      lines.append(f"    const {ctype} v{i} = team_lane<kTeam>("
                   f"{w.ref(x, ctype, str(attr % v))}, {attr // v});")
    elif op == "bcast":
      lines += [f"    {ctype} v{i}[kVec];",
                f"    {loop}v{i}[j] = {w.ref(args[0], ctype)};"]
    elif shape == "vec":
      lines += [f"    {ctype} v{i}[kVec];",
                f"    {loop}v{i}[j] = {w.text(op, kind, args, attr)};"]
    else:
      lines.append(f"    const {ctype} v{i} = "
                   f"{w.text(op, kind, args, attr)};")
  out_kind = KINDS[expr.out_dtype]
  if w.is_vec(expr.out):
    lines.append(f"    {loop}out[j] = {w.store(expr.out, out_kind)};")
  else:
    lines.append(f"    out[0] = {w.store(expr.out, out_kind)};")

  def ctype_of(dt):
    return CTYPES[KINDS[dt or expr.dtype]]
  return "\n".join([
      f"{_header(expr)}, lane-mixing: K = {k} on a team of {t} thread(s) "
      f"of {v} lane(s), K_out = {expr.k_out}: {len(expr.nodes)} node(s)",
      f"struct {name} {{",
      f"  static constexpr bool kReadsEdge = "
      f"{'true' if expr.reads_edge else 'false'};",
      f"  static constexpr bool kReadsDst = "
      f"{'true' if expr.reads_dst else 'false'};",
      f"  static constexpr int kLanes = {k}, kTeam = {t}, kVec = {v}, "
      f"kLoad = {w_load}, kSlots = {slots};",
      f"  static constexpr int kOut = {expr.k_out}, "
      f"kDstLanes = {expr.dst_lanes};",
      "  __device__ __forceinline__ static void apply(",
      f"      const {ctype_of(expr.dtype)} (&m_in)[kVec], "
      f"{ctype_of(expr.edge_dtype)} e_in,",
      f"      const {ctype_of(expr.dst_dtype)} "
      "(&d_in)[kDstLanes == 1 ? 1 : kVec],",
      f"      {CTYPES[out_kind]} (&out)[kOut == 1 ? 1 : kVec], int sub) {{",
      *lines,
      "  }",
      "};",
      ""])
