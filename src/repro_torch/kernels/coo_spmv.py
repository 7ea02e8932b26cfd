"""Generalized COO SpMV: the CUDA kernel's wrapper, its per-graph table, and
which of the port's COO calls it takes.

The kernel is ``csrc/coo_spmv.cu`` over ``csrc/coo_spmv_body.cuh``; its
header says what it computes, what bounds it and how it is designed.  It
replaces no Pallas kernel (the reference's COO paths are XLA scatters): on a
CUDA tensor it takes the place of :mod:`repro_torch.core.spmv`'s gather,
process, ``scatter_reduce_`` and ``index_add_`` chain for
:func:`~repro_torch.core.spmv.spmv_coo`, for
:func:`~repro_torch.core.spmv.spmv_coo_tiled` (whose ``num_tiles`` then does
not change the result) and for the ELL paths' spill merge, which folds the
spilled runs into the ELL rows' ``y`` and ``recv`` in place.  That chain
stays the plain version: it runs every call on CPU tensors, and on CUDA
tensors every call :func:`decide` does not send here.

A call goes to the kernel when the graph's ``dst`` is sorted (what
``coo_arrays`` builds; :func:`build_table` finds it once per graph), there
is one message leaf of rank 1 or 2, at most one destination-property leaf,
the reduce is add, min or max with the default identity and combine, and
:func:`repro_torch.kernels.process_expr.for_program` gives a process the
kernel takes: the same processes the ELL kernel runs (a shipped form, or a
traced ``process_message``: lanewise on ``[n, Q]``, or mixing the lanes of
``[n, K]``), the same instances built the same way (the shipped library at
its first launch; a traced process's own at its).  Every other call keeps
the PyTorch path: the generic reduce, any/all, messages of several leaves,
unsorted graphs.  :data:`launches` counts the kernel's calls by
:func:`~repro_torch.kernels.ell_spmv.config_key` (prefixed ``coo/``), and
:data:`torch_path` the CUDA calls that took the PyTorch path, by reason
(:data:`REASONS`); neither touches
:data:`repro_torch.kernels.ell_spmv.launches`.

A stream must be driven by one host thread at a time.  The frontier word,
its tag and the carry arrays are kept per (device, stream), and a call's
three launches read what its own earlier launches wrote there; two threads
whose launches interleave on one stream can read each other's and give a
wrong result, with no error.  A server holds to this: its rounds run
under its engine lock (``service/scheduler.py``).  The ELL kernel's sync
words (:mod:`repro_torch.kernels.ell_spmv`) have the same rule.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
import weakref
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch import _tree
from repro_torch.core import graph as graphlib
from repro_torch.core.semiring import _identity_for
from repro_torch.kernels import process_expr
from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.ell_spmv import (_DTYPE_CODE, _OP_CODE, _REDUCE_CODE,
                                          LaunchCounter, _reads, config_key,
                                          instance_fields, takes)
from repro_torch.kernels.process_expr import ProcessExpr

# Edges a warp reduces (a tile); a multiple of 32, so that a step's edges
# share a word of the heads bitmap.
TILE_EDGES = 1024
# Why a CUDA call took the PyTorch path.
REASONS = ("reduce", "message", "active", "dst_prop", "process", "unsorted")
# The C entry's flags (csrc/coo_spmv_body.cuh's CooFlags).
_MERGE, _VEC_MSG, _VEC_ACTIVE = 1, 2, 4


@dataclasses.dataclass(frozen=True)
class CooTable:
  """What the kernel keeps of one COO graph, made once, on its device.

  ``sorted``: ``dst`` is non-decreasing over the whole edge array (the
  padding's ``n - 1`` included); only then are the other fields made.
  ``src`` is an int32 copy of the sources with -1 where ``emask`` is
  false; ``heads`` a bitmap, bit ``e % 32`` of word ``e // 32`` set where
  edge e begins a run of equal ``dst``; ``dst`` the graph's as int64.  The
  edges are cut into ``num_tiles`` tiles of ``tile_edges`` (tile t holds
  edges ``[t * tile_edges, (t + 1) * tile_edges)``), and ``splits`` holds
  each run that crosses a tile boundary as ``(first tile, last tile, first
  slot, dst)``: its first tile's carry slot is 0 where the run begins that
  tile, else 1.
  """

  sorted: bool
  num_tiles: int
  tile_edges: int
  src: Optional[torch.Tensor] = None     # int32[cap]
  heads: Optional[torch.Tensor] = None   # int32[ceil(cap / 32)]
  dst: Optional[torch.Tensor] = None     # int64[cap]
  splits: Optional[torch.Tensor] = None  # int32[num_splits, 4]
  num_splits: int = 0
  # The carry arrays of the launches, by (stream, K_out, accumulator dtype):
  # launches on one stream run in order, so each stream has its own.
  _carries: Dict[Tuple[int, int, torch.dtype],
                 Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
                     default_factory=dict, compare=False, repr=False)

  def carry(self, stream: int, k_out: int, acc: torch.dtype
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The carries ``acc[num_tiles * 2 * k_out]`` and their flags
    ``uint8[num_tiles * 2]`` for launches on ``stream``, made once."""
    key = (stream, k_out, acc)
    got = self._carries.get(key)
    if got is None:
      dev = self.src.device
      got = self._carries[key] = (
          torch.empty((self.num_tiles * 2 * k_out,), dtype=acc, device=dev),
          torch.empty((self.num_tiles * 2,), dtype=torch.uint8, device=dev))
    return got


def build_table(g: graphlib.CooGraph,
                tile_edges: int = TILE_EDGES) -> CooTable:
  """The :class:`CooTable` of ``g``, made with tensor ops on its device
  (three reads back to the host: whether ``dst`` is sorted, and the counts
  of runs and of split runs)."""
  cap = g.capacity
  num_tiles = -(-cap // tile_edges)
  dst = g.dst.to(torch.int64)
  if cap > 1 and not bool((dst[1:] >= dst[:-1]).all()):
    return CooTable(False, num_tiles, tile_edges)
  dev = dst.device
  src = g.src.to(torch.int32)
  src.masked_fill_(~g.emask, -1)
  head = torch.ones(cap, dtype=torch.bool, device=dev)
  head[1:] = dst[1:] != dst[:-1]
  words = -(-cap // 32)
  bits = torch.zeros(words * 32, dtype=torch.uint8, device=dev)
  bits[:cap] = head
  weight = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                        device=dev)
  # Bytes in order are the words' little-endian bytes (CUDA and x86).
  heads = (bits.view(-1, 8) * weight).sum(1, dtype=torch.int32).to(
      torch.uint8).view(torch.int32)
  starts = torch.nonzero(head).squeeze(1)
  ends = torch.cat([starts[1:], starts.new_tensor([cap])])
  t0, t1 = starts // tile_edges, (ends - 1) // tile_edges
  split = t1 > t0
  splits = torch.stack([t0, t1, (starts != t0 * tile_edges).long(),
                        dst[starts]], 1)[split].to(torch.int32).contiguous()
  return CooTable(True, num_tiles, tile_edges, src, heads, dst, splits,
                  int(splits.shape[0]))


_tables: Dict[int, CooTable] = {}
_tables_lock = threading.Lock()


def table(g: graphlib.CooGraph) -> CooTable:
  """``g``'s :class:`CooTable`, made at its first use and kept while ``g``
  lives."""
  key = id(g)
  got = _tables.get(key)
  if got is None:
    with _tables_lock:
      got = _tables.get(key)
      if got is None:
        got = _tables[key] = build_table(g)
        weakref.finalize(g, _tables.pop, key, None)
  return got


class Call(NamedTuple):
  """One COO SpMV the kernel takes: the process, the message and property
  leaves, the message's tree, the graph's table."""

  process: Union[str, ProcessExpr]
  msg: torch.Tensor
  dprop: Optional[torch.Tensor]
  treedef: object
  table: CooTable
  reduce_kind: str


launches = LaunchCounter()
torch_path: Dict[str, int] = dict.fromkeys(REASONS, 0)

# The frontier pass's word and the launches' tags, one of each a stream
# (launches on one stream run in order, from one host thread: see the
# module's docstring): the pass writes the launch's tag to the word when it
# sees an inactive source.
_frontiers: Dict[Tuple[int, int], torch.Tensor] = {}
_tags: Dict[Tuple[int, int], int] = {}


def _frontier(index: int, stream: int) -> Tuple[torch.Tensor, int]:
  key = (index, stream)
  word = _frontiers.get(key)
  if word is None:
    word = _frontiers[key] = torch.zeros(
        1, dtype=torch.int32, device=torch.device("cuda", index))
  tag = _tags[key] = _tags.get(key, 0) % 0x7fffffff + 1
  return word, tag


def decide(g: graphlib.CooGraph, msg, active: torch.Tensor, dst_prop,
           program, process: Union[str, ProcessExpr, None] = None
           ) -> Union[Call, str]:
  """The kernel's :class:`Call` for one COO SpMV, or the reason (one of
  :data:`REASONS`) it keeps the PyTorch path, whatever the device.
  ``process``: the process a caller has already resolved for these leaves
  and the graph's edge dtype (``for_program``'s answer), not resolved
  again."""
  if (program.reduce_kind not in _REDUCE_CODE or program.reduce is not None
      or program.reduce_identity is not None):
    return "reduce"
  leaves, treedef = _tree.tree_flatten(msg)
  if len(leaves) != 1 or leaves[0].ndim not in (1, 2):
    return "message"
  m = leaves[0]
  if active.shape != (m.shape[0],) or active.dtype != torch.bool:
    return "active"
  dp_leaves = (_tree.tree_leaves(dst_prop) if program.process_reads_dst
               else [])
  if len(dp_leaves) > 1:
    return "dst_prop"
  dp = dp_leaves[0] if dp_leaves else None
  if process is None:
    process = process_expr.for_program(program, m, g.w, dp)
  if (isinstance(process, process_expr.Refused)
      or not takes(m, g.w, process, program.reduce_kind, dp, rows=g.n)):
    return "process"
  t = table(g)
  if not t.sorted:
    return "unsorted"
  return Call(process, m, dp, treedef, t, program.reduce_kind)


def route(g: graphlib.CooGraph, msg, active: torch.Tensor, dst_prop,
          program, process: Union[str, ProcessExpr, None] = None
          ) -> Optional[Call]:
  """:func:`decide` for a call on CUDA tensors, counting the reason where it
  keeps the PyTorch path; None for CPU tensors (the plain version)."""
  if not g.src.is_cuda:
    return None
  got = decide(g, msg, active, dst_prop, program, process)
  if isinstance(got, str):
    torch_path[got] += 1
    return None
  return got


def _out(call: Call) -> Tuple[torch.dtype, int, bool]:
  """``(dtype, K_out, squeezed)`` of the call's result: ``y`` is ``[n]``
  when squeezed, else ``[n, K_out]``."""
  p, m = call.process, call.msg
  if isinstance(p, ProcessExpr):
    if p.lane_mixing:
      return p.out_dtype, p.k_out, p.squeezed
    return p.out_dtype, (m.shape[1] if m.ndim == 2 else 1), m.ndim == 1
  return m.dtype, (m.shape[1] if m.ndim == 2 else 1), m.ndim == 1


def spmv(call: Call, g: graphlib.CooGraph, active: torch.Tensor,
         with_recv: bool = True):
  """``(y, recv)`` of the call, as :func:`repro_torch.core.spmv.spmv_coo`
  gives them (``recv`` None without ``with_recv``)."""
  dtype, k_out, squeezed = _out(call)
  shape = (g.n,) if squeezed else (g.n, k_out)
  y = torch.full(shape, _identity_for(call.reduce_kind, dtype), dtype=dtype,
                 device=call.msg.device)
  recv = (torch.zeros((g.n,), dtype=torch.bool, device=y.device)
          if with_recv else None)
  _launch(call, g, active, y, recv, merge=False)
  return _tree.tree_unflatten(call.treedef, [y]), recv


def merge(call: Call, g: graphlib.CooGraph, active: torch.Tensor, y,
          recv: torch.Tensor):
  """Fold the call's runs into ``(y, recv)``, another path's result for the
  same process on the same vertices, in place (``merge_spill``)."""
  dtype, k_out, squeezed = _out(call)
  leaves = _tree.tree_leaves(y)
  shape = (g.n,) if squeezed else (g.n, k_out)
  if (len(leaves) != 1 or tuple(leaves[0].shape) != shape
      or leaves[0].dtype != dtype or not leaves[0].is_contiguous()
      or recv.shape != (g.n,) or recv.dtype != torch.bool
      or not recv.is_contiguous()):
    raise ValueError(f"coo_spmv.merge: y must be one contiguous {dtype} "
                     f"leaf {list(shape)} and recv bool[{g.n}]")
  _launch(call, g, active, leaves[0], recv, merge=True)
  return y, recv


def _launch(call: Call, g: graphlib.CooGraph, active: torch.Tensor,
            y: torch.Tensor, recv: Optional[torch.Tensor],
            merge: bool) -> None:
  t, process = call.table, call.process
  m = call.msg if call.msg.ndim == 2 else call.msg[:, None]
  m = m.contiguous()
  q = m.shape[1]
  lanes = isinstance(process, ProcessExpr) and process.lane_mixing
  dtype, k_out, _ = _out(call)
  reads_edge, reads_dst = _reads(process)
  dp = None
  if reads_dst:
    dp = call.dprop if call.dprop.ndim == 2 else call.dprop[:, None]
    dp = dp.contiguous()
  if lanes:
    q_tile = q
    vec = m.data_ptr() % (process.lane_layout[2] * m.element_size()) == 0
  else:
    q_tile = min(q, 8)
    vec = q % 4 == 0 and m.data_ptr() % 16 == 0
  flags = (_MERGE if merge else 0) | (_VEC_MSG if vec else 0)
  name = process if isinstance(process, str) else process.name
  library = (LIBRARY if isinstance(process, str) or process.shipped
             else library_for(process, call.reduce_kind))
  lib = library.load()
  index = y.get_device()
  stream = torch._C._cuda_getCurrentRawStream(index)
  carry = carry_got = None
  if t.num_splits:
    carry, carry_got = t.carry(stream, k_out, (
        torch.float32 if dtype in (torch.float16, torch.bfloat16) else dtype))
  word, tag = _frontier(index, stream)
  active = active.contiguous()
  if active.data_ptr() % 16 == 0:
    flags |= _VEC_ACTIVE
  rc = lib.graphmat_coo_spmv(
      t.src.data_ptr(), g.w.data_ptr(), t.heads.data_ptr(),
      t.dst.data_ptr(), m.data_ptr(), active.data_ptr(),
      None if dp is None else dp.data_ptr(),
      t.splits.data_ptr() if t.num_splits else None, y.data_ptr(),
      None if recv is None else recv.data_ptr(),
      None if carry is None else carry.data_ptr(),
      None if carry_got is None else carry_got.data_ptr(), word.data_ptr(),
      g.capacity, m.shape[0], t.tile_edges, t.num_tiles, t.num_splits, q,
      q_tile, 1 if dp is None else dp.shape[1], k_out, flags, tag,
      _DTYPE_CODE[m.dtype], _DTYPE_CODE[g.w.dtype] if reads_edge else -1,
      _DTYPE_CODE[dp.dtype] if reads_dst else -1, _DTYPE_CODE[dtype],
      _REDUCE_CODE[call.reduce_kind], _OP_CODE.get(name, 0), index, stream)
  library.check(rc, "coo_spmv")
  launches.add("coo/" + config_key(q, m.dtype, call.reduce_kind, name,
                                   lanes))


def _bind(lib: ctypes.CDLL) -> None:
  fn = lib.graphmat_coo_spmv
  fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong] * 2
                 + [ctypes.c_int] * 16 + [ctypes.c_void_p])
  fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("coo_spmv.cu", _bind)

# A generated instance: the body over one traced process, for its operand
# dtypes and one reduce, with the shipped library's C entry point (dtypes,
# K_out and reduce checked, op ignored).
_GENERATED_SOURCE = """\
// The COO kernel of coo_spmv_body.cuh over one traced process_message, for
// {what} and the {reduce} reduce (written by kernels/coo_spmv.py).
#include "coo_spmv_body.cuh"

namespace {{
{functor}
}}  // namespace

extern "C" int graphmat_coo_spmv(
    const void* src, const void* w, const void* heads, const void* dst,
    const void* msg, const void* active, const void* dprop,
    const void* splits, void* y, void* recv, void* carry, void* carry_got,
    void* frontier, long long cap, long long n_src, int tile_edges,
    int num_tiles, int num_splits, int q, int q_tile, int kd, int k_out,
    int flags, int tag, int dtype, int edge_dtype, int dst_dtype,
    int out_dtype, int reduce, int op, int device, void* stream) {{
  (void)op;
  (void)edge_dtype;
  (void)dst_dtype;
  if ({checks}) {{
    return static_cast<int>(cudaErrorInvalidValue);
  }}
  const CooArgs args{{static_cast<const int*>(src), w,
                     static_cast<const unsigned*>(heads),
                     static_cast<const long long*>(dst), msg,
                     static_cast<const uint8_t*>(active), dprop,
                     static_cast<const int4*>(splits), y,
                     static_cast<uint8_t*>(recv), carry,
                     static_cast<uint8_t*>(carry_got),
                     static_cast<unsigned*>(frontier), cap, n_src,
                     tile_edges, num_tiles, num_splits, q, q_tile, kd,
                     k_out, flags, static_cast<unsigned>(tag)}};
  return run_coo<Operands<{types}>, {reduce_code}, TracedProcess{lanes}>(
      args, device, stream);
}}

extern "C" const char* graphmat_cuda_error_string(int code) {{
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}}
"""
_generated: Dict[Tuple[str, str], CudaLibrary] = {}
_generated_lock = threading.Lock()


def generated_source(process: ProcessExpr, reduce_kind: str) -> str:
  """The CUDA source of ``process``'s COO instance for ``reduce_kind``."""
  return _GENERATED_SOURCE.format(**instance_fields(process, reduce_kind))


def library_for(process: ProcessExpr, reduce_kind: str) -> CudaLibrary:
  """The traced process's own COO instance for ``reduce_kind`` (made once,
  built at its first load)."""
  key = (process.digest, reduce_kind)
  lib = _generated.get(key)
  if lib is None:
    with _generated_lock:
      lib = _generated.get(key)
      if lib is None:
        lib = _generated[key] = CudaLibrary(
            f"coo_spmv_{process.digest}_{reduce_kind}", _bind,
            text=generated_source(process, reduce_kind))
  return lib
