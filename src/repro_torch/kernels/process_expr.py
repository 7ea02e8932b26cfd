"""A vertex program's ``process_message``, traced into the expression the
CUDA ELL kernel compiles.

The reference's kernel is a template over the user's per-edge function:
``ell_spmv_pallas`` traces ``process`` inline into its body
(``src/repro/kernels/ell_spmv.py:127``), and ``kernels/ops.py`` hands it the
program's own ``process_message``.  The port does the same in three steps:

1. :func:`trace` runs the callable under ``make_fx`` on fake tensors at the
   call's ranks and dtypes (scalar programs ``m [E]``, ``e [E]``, ``d
   [E]``; lane programs ``m [E, Q]``, ``e [E, 1]``, ``d [E, Kd]``) and reads
   the flat aten graph into a :class:`ProcessExpr`: which of ``m``, ``e``
   and ``d`` it reads, a list of per-lane elementwise nodes, constants kept
   as exact bit patterns, and the output's dtype.
2. :meth:`ProcessExpr.functor_source` writes the expression as a CUDA
   functor (``kReadsEdge``, ``kReadsDst``, ``apply(m, e, d)``) for the
   kernel's body (``csrc/ell_spmv_body.cuh``).
3. ``kernels/ell_spmv.py`` builds the functor's instance at its first
   launch, unless the expression equals one of the five shipped forms node
   for node (:attr:`ProcessExpr.shipped`), whose instances ship compiled.

What the kernel takes, and so what a trace accepts: a per-lane expression
over one dtype among float32, float16 and int32, of ``add``, ``sub`` (and
``rsub``), ``mul``, ``div``, ``neg``, ``abs``, ``reciprocal``,
``minimum``, ``maximum``, ``clamp``, ``where``, the six comparisons,
logical and bitwise and / or / xor / not on booleans, ``exp``, ``log``,
``sqrt``, ``rsqrt``, and casts of booleans to the message dtype; Python
scalars and 0-d tensors as constants.  Anything else is refused with a
reason (:class:`Refused`): a trace that fails (data-dependent control
flow), an op outside that list (a reduction or an index across the lane
axis among them), a captured tensor that is not 0-d, an output not shaped
as the message, or inputs read and output in different dtypes.  A program
whose ``process_reads_dst`` is False gets ``d = 0``, as the reference's
kernel gets a zero ``dprop`` (``src/repro/kernels/ops.py:53``).

Arithmetic follows eager CUDA op by op: float16 values are computed in
float32 and rounded to half after each op; constants in arithmetic,
comparisons and ``clamp`` are taken in float32 (int32 for int32 programs),
and in ``where``, ``minimum`` and ``maximum`` in the message dtype; a
division by a constant is a product with its float32 reciprocal, as eager
CUDA computes it (the CPU divides).  :meth:`ProcessExpr.evaluate` runs the
expression with torch ops, which is how the tests hold it to the callable.

Traces are cached per (callable, dtypes, scalar or lane, Kd = 1 or not,
``process_reads_dst``), so the per-superstep eligibility checks of the
``cuda_ell`` backend pay a dictionary lookup; a closure's values are read
at the first trace.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import logging
import threading
import weakref
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

# The sizes of the fake tensors a trace runs on: E edges, Q query lanes
# (distinct, so that a lane-mixing op shows in the output's shape).
_EDGES, _LANES = 4, 3

DTYPES = {torch.float32: "f32", torch.float16: "f16", torch.int32: "i32"}
_TORCH = {kind: dtype for dtype, kind in DTYPES.items()} | {"bool": torch.bool}
_NP = {"f32": np.float32, "f16": np.float16, "i32": np.int32}
_BITS = {"f32": np.uint32, "f16": np.uint16, "i32": np.uint32}

_BINARY = {"add": "add", "sub": "sub", "mul": "mul", "div": "div",
           "minimum": "min", "maximum": "max"}
_COMPARE = ("lt", "le", "gt", "ge", "eq", "ne")
_LOGICAL = {"logical_and": "and", "logical_or": "or", "logical_xor": "xor",
            "bitwise_and": "and", "bitwise_or": "or", "bitwise_xor": "xor"}
_NOT = ("logical_not", "bitwise_not")
_UNARY = ("neg", "abs", "reciprocal", "exp", "log", "sqrt", "rsqrt")
_IDENTITY = ("lift_fresh_copy", "lift_fresh", "clone", "alias", "detach")
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
Node = Tuple  # (op, result kind "T" | "bool", (ref, ...))


@dataclasses.dataclass(frozen=True)
class Refused:
  """Why the kernel cannot take a process."""

  reason: str


@dataclasses.dataclass(frozen=True)
class _Const:
  """A constant before its use decides its type: a Python number, or the
  value of a 0-d tensor already rounded to ``dtype``."""

  value: Any
  dtype: Optional[torch.dtype] = None


class _Refuse(Exception):
  pass


def _const_ref(c: _Const, kind: str) -> Ref:
  """The constant as a literal of ``kind`` (its exact bit pattern)."""
  value = c.value
  if kind == "bool":
    return ("c", "bool", int(bool(value)))
  if kind == "i32":
    if isinstance(value, float) or (c.dtype is not None
                                    and c.dtype.is_floating_point):
      raise _Refuse(f"uses the float constant {value!r} in an int32 program")
    value = int(value)
    if not -2**31 <= value < 2**31:
      raise _Refuse(f"uses the constant {value} outside int32")
  bits = np.array(value, dtype=_NP[kind]).view(_BITS[kind])
  return ("c", kind, int(bits))


def const_value(ref: Ref):
  """A constant ref's value as a Python number."""
  _, kind, bits = ref
  if kind == "bool":
    return bool(bits)
  value = np.array(bits, dtype=_BITS[kind]).view(_NP[kind])
  return int(value) if kind == "i32" else float(value)


@dataclasses.dataclass(frozen=True)
class ProcessExpr:
  """A traced per-lane process: ``nodes`` in order, ``out`` the result.

  Two expressions are equal when their dtype, nodes and output are; the
  callable, the lane form and the shipped form it equals are carried
  beside them.
  """

  dtype: torch.dtype
  nodes: Tuple[Node, ...]
  out: Ref
  fn: Callable = dataclasses.field(compare=False, repr=False)
  lane: bool = dataclasses.field(compare=False)
  shipped: Optional[str] = dataclasses.field(default=None, compare=False)

  def _reads(self, name: str) -> bool:
    return self.out == (name,) or any(
        (name,) in args for _, _, args in self.nodes)

  @functools.cached_property
  def reads_edge(self) -> bool:
    return self._reads("e")

  @functools.cached_property
  def reads_dst(self) -> bool:
    return self._reads("d")

  @functools.cached_property
  def digest(self) -> str:
    """A hash of the dtype, nodes and output (the build cache's key)."""
    return hashlib.sha1(repr((DTYPES[self.dtype], self.nodes, self.out)
                             ).encode()).hexdigest()[:12]

  @property
  def name(self) -> str:
    """The launch counter's name of the instance that runs it."""
    return self.shipped or f"traced_{self.digest[:8]}"

  def plain(self, m: torch.Tensor, e: torch.Tensor, d: torch.Tensor
            ) -> torch.Tensor:
    """The callable itself, as ``ell_spmv_ref``'s ``process`` (``m [...,
    Q]``, ``e [...]``, ``d [..., Kd]``): at the ranks it was traced at."""
    if self.lane:
      return self.fn(m, e[..., None], d)
    return self.fn(m[..., 0], e, d[..., 0])[..., None]

  def evaluate(self, m: torch.Tensor, e: torch.Tensor, d: torch.Tensor
               ) -> torch.Tensor:
    """The expression in torch ops, in the callable's broadcasting form."""
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

    for op, _, args in self.nodes:
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
        v = get(args[0]).to(self.dtype)
      else:
        v = _EVAL_UNARY[op](get(args[0]))
      values.append(v)
    return get(self.out, as_tensor=True)

  def functor_source(self, name: str = "TracedProcess") -> str:
    """The expression as a CUDA functor for ``csrc/ell_spmv_body.cuh``."""
    return _emit(self, name)


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

  def __init__(self, kind: str):
    self.kind = kind  # the message dtype's kind
    self.nodes = []

  def add(self, op: str, result: str, *args) -> Ref:
    self.nodes.append((op, result, tuple(args)))
    return ("v", len(self.nodes) - 1)

  def result_kind(self, ref: Ref) -> str:
    if ref[0] == "v":
      return self.nodes[ref[1]][1]
    if ref[0] == "c":
      return "bool" if ref[1] == "bool" else "T"
    return "T"

  def value(self, x, role: str) -> Ref:
    """An operand of a value op: a bool ref cast to the message dtype, a
    constant as a literal (``role`` "opmath": float32 or int32; "value":
    the message dtype)."""
    if isinstance(x, _Const):
      if self.kind == "i32" or role == "value":
        return _const_ref(x, self.kind)
      return _const_ref(x, "f32")
    if self.result_kind(x) == "bool":
      return self.add("cast", "T", x)
    return x

  def boolean(self, x) -> Ref:
    if isinstance(x, _Const):
      if not isinstance(x.value, bool) and x.dtype is not torch.bool:
        raise _Refuse(f"uses {x.value!r} as a boolean")
      return _const_ref(x, "bool")
    if self.result_kind(x) != "bool":
      raise _Refuse("uses a value of the message dtype as a boolean")
    return x


def _op_name(target) -> Tuple[str, str]:
  packet = getattr(target, "overloadpacket", None)
  if packet is None:
    raise _Refuse(f"calls {target!r}, which is not an aten op")
  return packet.__name__, target._overloadname


def _read_graph(gm, dtype: torch.dtype, reads_dst: bool
                ) -> Tuple[_Builder, Ref]:
  kind = DTYPES[dtype]
  b = _Builder(kind)
  env: Dict[Any, Any] = {}
  placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
  for node, ref in zip(placeholders, (("m",), ("e",), ("d",))):
    env[node] = ref if (ref != ("d",) or reads_dst) else _const_ref(
        _Const(0, dtype), kind)
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
    name, overload = _op_name(node.target)
    args = []
    for a in node.args:
      if isinstance(a, torch.fx.Node):
        args.append(env[a])
      elif isinstance(a, (bool, int, float)) or a is None:
        args.append(a if a is None else _Const(a))
      elif name in _REDUCING or name in _INDEXING:
        args.append(a)  # refused below, with the op's reason
      else:
        raise _Refuse(f"passes {a!r} to aten.{name}")
    kwargs = dict(node.kwargs)
    val = node.meta.get("val")
    env[node] = _node(b, name, overload, args, kwargs, val, dtype)
  if not isinstance(out, torch.fx.Node):
    raise _Refuse(f"returns {type(out).__name__}, not one tensor")
  val = out.meta.get("val")
  if val is None or val.dtype != dtype:
    raise _Refuse(f"returns {getattr(val, 'dtype', None)} for {dtype} "
                  "messages (message, edge, destination and result must "
                  "share one dtype)")
  ref = env[out]
  if isinstance(ref, _Const):
    raise _Refuse("returns a constant, not a value per edge and lane")
  return b, ref


def _node(b: _Builder, name: str, overload: str, args, kwargs, val,
          dtype: torch.dtype):
  """One aten call as IR (a ref, or a constant for an identity op on one)."""
  if name in _IDENTITY:
    return args[0]
  if name == "scalar_tensor":
    return _Const(np.array(args[0].value, dtype=_np_dtype(
        kwargs.get("dtype") or torch.float32)).item(), kwargs.get("dtype"))
  if name in _REDUCING and not (name in ("max", "min")
                                and overload == "other"):
    raise _Refuse(f"reduces across the lane axis (aten.{name})")
  if name in _INDEXING:
    raise _Refuse(f"indexes or reshapes across the lane axis (aten.{name})")
  if val is not None and val.dtype not in (dtype, torch.bool):
    raise _Refuse(f"mixes dtypes: aten.{name} gives {val.dtype} in a "
                  f"{dtype} program")
  alpha = kwargs.pop("alpha", 1)
  if name in ("add", "sub", "rsub") and alpha != 1:
    raise _Refuse(f"passes alpha={alpha} to aten.{name}")
  if name == "_to_copy":
    target = kwargs.pop("dtype", None)
    if kwargs or target != dtype:
      raise _Refuse(f"casts to {target} with {kwargs or 'no options'}; "
                    "only casts to the message dtype are taken")
    x = args[0]
    if isinstance(x, _Const):
      return _Const(x.value, dtype)
    return b.add("cast", "T", x) if b.result_kind(x) == "bool" else x
  if kwargs:
    raise _Refuse(f"passes {kwargs} to aten.{name}")
  if all(isinstance(a, _Const) or a is None for a in args):
    raise _Refuse(f"computes aten.{name} on constants only")
  if name in ("max", "min") and overload == "other":
    name = "maximum" if name == "max" else "minimum"
  if name == "rsub":
    return b.add("sub", "T", b.value(args[1], "opmath"),
                 b.value(args[0], "opmath"))
  if name in _BINARY and len(args) == 2:
    op = _BINARY[name]
    role = "value" if op in ("min", "max") else "opmath"
    return b.add(op, "T", b.value(args[0], role), b.value(args[1], role))
  if name in _COMPARE and len(args) == 2:
    return b.add(name, "bool", b.value(args[0], "opmath"),
                 b.value(args[1], "opmath"))
  if name in _LOGICAL and len(args) == 2:
    return b.add(_LOGICAL[name], "bool", b.boolean(args[0]),
                 b.boolean(args[1]))
  if name in _NOT and len(args) == 1:
    return b.add("not", "bool", b.boolean(args[0]))
  if name in _UNARY and len(args) == 1:
    return b.add(name, "T", b.value(args[0], "opmath"))
  if name in ("clamp", "clamp_min", "clamp_max") and 2 <= len(args) <= 3:
    lo, hi = (args[1], args[2] if len(args) == 3 else None)
    if name == "clamp_max":
      lo, hi = None, args[1]
    bounds = [("none",) if x is None else b.value(x, "opmath")
              for x in (lo, hi)]
    return b.add("clamp", "T", b.value(args[0], "opmath"), *bounds)
  if name == "where" and len(args) == 3:
    return b.add("where", "T", b.boolean(args[0]),
                 b.value(args[1], "value"), b.value(args[2], "value"))
  raise _Refuse(f"uses aten.{name}.{overload}, which is not among the "
                "per-lane ops the kernel takes")


def _np_dtype(dtype: torch.dtype):
  return {torch.float32: np.float32, torch.float16: np.float16,
          torch.int32: np.int32, torch.bool: np.bool_,
          torch.float64: np.float64, torch.int64: np.int64}.get(dtype,
                                                              np.float64)


def _live(b: _Builder, out: Ref) -> Tuple[Tuple[Node, ...], Ref]:
  """The nodes ``out`` depends on, renumbered in order."""
  used = set()
  stack = [out]
  while stack:
    ref = stack.pop()
    if ref[0] == "v" and ref[1] not in used:
      used.add(ref[1])
      stack.extend(b.nodes[ref[1]][2])
  order = sorted(used)
  new = {old: i for i, old in enumerate(order)}

  def ren(ref):
    return ("v", new[ref[1]]) if ref[0] == "v" else ref

  nodes = tuple((op, kind, tuple(ren(a) for a in args))
                for op, kind, args in (b.nodes[i] for i in order))
  return nodes, ren(out)


_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_LOCK = threading.Lock()


def trace(fn: Callable, dtype: torch.dtype, *, lane: bool,
          edge_dtype: Optional[torch.dtype] = None,
          dst_dtype: Optional[torch.dtype] = None, kd: int = 1,
          reads_dst: bool = True) -> Union[ProcessExpr, Refused]:
  """``fn(m, e, d)`` as a :class:`ProcessExpr`, or why the kernel cannot
  take it.

  ``dtype`` is the message's; ``edge_dtype`` and ``dst_dtype`` default to
  it; ``lane`` traces the ``[E, Q]`` form with a ``[E, Kd]`` destination
  property (``kd`` 1 or Q), else the ``[E]`` form.  ``reads_dst`` False
  makes ``d`` the constant 0.
  """
  edge_dtype = edge_dtype or dtype
  dst_dtype = dst_dtype or dtype
  key = (dtype, edge_dtype, dst_dtype, lane, kd == 1, reads_dst)
  with _LOCK:
    try:
      per_fn = _CACHE.setdefault(fn, {})
    except TypeError:  # not weakly referenceable: traced every call
      per_fn = {}
    hit = per_fn.get(key)
    if hit is None:
      hit = per_fn[key] = _trace(fn, dtype, edge_dtype, dst_dtype, lane, kd,
                                 reads_dst)
  return hit


def _trace(fn, dtype, edge_dtype, dst_dtype, lane, kd, reads_dst,
           match: bool = True):
  from torch.fx.experimental.proxy_tensor import make_fx
  if dtype not in DTYPES:
    return Refused(f"has {dtype} messages; the kernel takes float32, "
                   "float16 and int32")
  m_shape = (_EDGES, _LANES) if lane else (_EDGES,)
  shapes = (m_shape, (_EDGES, 1) if lane else (_EDGES,),
            ((_EDGES, 1 if kd == 1 else _LANES) if lane else (_EDGES,)))
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
  try:
    b, out = _read_graph(gm, dtype, reads_dst)
    out_val = next(n for n in gm.graph.nodes if n.op == "output").args[0]
    shape = tuple(out_val.meta["val"].shape)
    if shape != m_shape:
      raise _Refuse(f"returns shape {list(shape)} for messages "
                    f"{list(m_shape)} (it must act lane by lane, K_out = K)")
    nodes, out = _live(b, out)
  except _Refuse as exc:
    return Refused(str(exc))
  expr = ProcessExpr(dtype, nodes, out, fn=fn, lane=lane)
  for name, t in (("edge value", edge_dtype), ("destination property",
                                               dst_dtype)):
    read = expr.reads_edge if name == "edge value" else expr.reads_dst
    if read and t != dtype:
      return Refused(f"reads the {name} as {t} in a {dtype} program "
                     "(message, edge, destination and result must share "
                     "one dtype)")
  for form, other in (_shipped_forms(dtype, lane, kd) if match
                      else {}).items():
    if other == expr:
      return dataclasses.replace(expr, shipped=form)
  return expr


@functools.lru_cache(maxsize=None)
def _shipped_forms(dtype: torch.dtype, lane: bool, kd: int
                   ) -> Dict[str, ProcessExpr]:
  """The five forms compiled into the shipped library, traced as a user's
  callable would be (``vertex_program.PROCESS_FORMS``)."""
  from repro_torch.core.vertex_program import DST_FORMS, PROCESS_FORMS
  out = {}
  for form, fn in PROCESS_FORMS.items():
    got = _trace(fn, dtype, dtype, dtype, lane, kd, form in DST_FORMS,
                 match=False)
    if isinstance(got, ProcessExpr):
      out[form] = dataclasses.replace(got, shipped=form)
  return out


def for_program(program, msg: torch.Tensor, vals: torch.Tensor,
                dprop: Optional[torch.Tensor]
                ) -> Union[str, ProcessExpr, Refused]:
  """What the kernel runs for ``program`` on one call: its ``process_op``
  (a shipped form by name), its traced ``process_message``, or why
  neither.  ``msg`` is the single message leaf ([n] or [n, Q]); ``dprop``
  the single destination-property leaf when the program reads it."""
  if program.reduce_kind not in ("add", "min", "max"):
    return Refused(f"its reduce_kind is {program.reduce_kind!r}: the kernel "
                   "reduces by add, min or max (a generic reduce runs on the "
                   "torch backends)")
  if program.process_op is not None:
    return program.process_op
  lane = msg.ndim == 2
  reads_dst = program.process_reads_dst
  kd = (dprop.shape[1] if lane and reads_dst and dprop is not None
        and dprop.ndim == 2 else 1)
  return trace(program.process_message, msg.dtype, lane=lane,
               edge_dtype=vals.dtype,
               dst_dtype=(dprop.dtype if reads_dst and dprop is not None
                          else msg.dtype),
               kd=kd, reads_dst=reads_dst)


# ---------------------------------------------------------------------------
# The CUDA functor
# ---------------------------------------------------------------------------

_CMP_OP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
           "ne": "!="}
_LOGIC_OP = {"and": "&&", "or": "||", "xor": "!="}


def _literal(ref: Ref, compute: str) -> str:
  """A constant in the functor's compute type (float for float32 and
  float16 programs, int for int32), by its bit pattern."""
  _, kind, bits = ref
  if kind == "bool":
    return "true" if bits else "false"
  if compute == "int":
    return f"static_cast<int>(0x{bits:08x}u)"
  if kind == "f16":
    bits = int(np.array(bits, np.uint16).view(np.float16).astype(
        np.float32).view(np.uint32))
  return f"__uint_as_float(0x{bits:08x}u)"


def _emit(expr: ProcessExpr, name: str) -> str:
  half = expr.dtype == torch.float16
  compute = "int" if expr.dtype == torch.int32 else "float"
  ctype = {"f32": "float", "f16": "__half", "i32": "int"}[DTYPES[expr.dtype]]
  lines = []

  def ref(r):
    if r[0] == "v":
      return f"v{r[1]}"
    if r[0] == "c":
      return _literal(r, compute)
    return r[0]

  def rounded(text):
    return f"round_half({text})" if half else text

  num = f"Num<{compute}>"
  for i, (op, kind, args) in enumerate(expr.nodes):
    a = [ref(r) for r in args]
    if op in ("add", "sub", "mul", "min", "max"):
      text = f"{num}::{op}({a[0]}, {a[1]})"
      if op not in ("min", "max"):
        text = rounded(text)
    elif op == "div":
      if args[1][0] == "c":  # a product with the float32 reciprocal
        c = np.float32(const_value(args[1]))
        with np.errstate(divide="ignore", over="ignore"):
          inv = np.float32(1.0) / c
        text = rounded(f"{num}::mul({a[0]}, __uint_as_float("
                       f"0x{int(inv.view(np.uint32)):08x}u))")
      else:
        text = rounded(f"__fdiv_rn({a[0]}, {a[1]})")
    elif op == "neg":
      text = f"{num}::sub(0, {a[0]})" if compute == "int" else f"-{a[0]}"
    elif op == "abs":
      text = (f"({a[0]} < 0 ? {num}::sub(0, {a[0]}) : {a[0]})"
              if compute == "int" else f"fabsf({a[0]})")
    elif op == "reciprocal":
      text = rounded(f"__fdiv_rn(1.0f, {a[0]})")
    elif op == "exp":
      text = rounded(f"expf({a[0]})")
    elif op == "log":
      text = rounded(f"logf({a[0]})")
    elif op == "sqrt":
      text = rounded(f"__fsqrt_rn({a[0]})")
    elif op == "rsqrt":
      text = rounded(f"rsqrtf({a[0]})")
    elif op in _CMP_OP:
      text = f"({a[0]} {_CMP_OP[op]} {a[1]})"
    elif op in _LOGIC_OP:
      text = f"({a[0]} {_LOGIC_OP[op]} {a[1]})"
    elif op == "not":
      text = f"!{a[0]}"
    elif op == "cast":
      text = f"({a[0]} ? {num}::one() : {num}::zero())"
    elif op == "where":
      text = f"({a[0]} ? {a[1]} : {a[2]})"
    elif op == "clamp":
      x = a[0]
      if args[1] != ("none",):
        x = f"{num}::max({x}, {a[1]})"
      if args[2] != ("none",):
        x = f"{num}::min({x}, {a[2]})"
      if compute == "int":
        text = x
      else:  # NaN stays NaN, as in torch.clamp
        text = rounded(f"({a[0]} != {a[0]} ? {a[0]} : {x})")
    else:
      raise ValueError(f"no CUDA text for {op}")
    vtype = "bool" if kind == "bool" else compute
    lines.append(f"    const {vtype} v{i} = {text};")
  params = []
  for var in ("m", "e", "d"):
    if not expr._reads(var):
      params.append(f"{ctype} /*{var}*/")
    elif half:
      params.append(f"{ctype} {var}_h")
      lines.insert(0, f"    const float {var} = __half2float({var}_h);")
    else:
      params.append(f"{ctype} {var}")
  result = ref(expr.out)
  if expr.out[0] == "c":
    result = _literal(expr.out, compute)
  ret = f"__float2half_rn({result})" if half else result
  return "\n".join([
      f"// {DTYPES[expr.dtype]} process traced from "
      f"{getattr(expr.fn, '__qualname__', type(expr.fn).__name__)}: "
      f"{len(expr.nodes)} node(s)",
      f"struct {name} {{",
      f"  static constexpr bool kReadsEdge = "
      f"{'true' if expr.reads_edge else 'false'};",
      f"  static constexpr bool kReadsDst = "
      f"{'true' if expr.reads_dst else 'false'};",
      f"  __device__ __forceinline__ static {ctype} apply("
      + ", ".join(params) + ") {",
      *lines,
      f"    return {ret};",
      "  }",
      "};",
      ""])
