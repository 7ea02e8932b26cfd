"""Generalized ELL SpMV / multi-query SpMM: the CUDA kernel's wrapper.

Replaces ``src/repro/kernels/ell_spmv.py::ell_spmv_pallas``, both grids: the
single-query grid (Q = 1) and the ``block_queries`` multi-query SpMM (Q > 1).
The kernel is ``csrc/ell_spmv.cu``; its header says what it computes, what
bounds it (bytes: 1 mask byte per ELL slot, 4 bytes of cols and, for the
forms that read the edge, 4 of vals per valid slot, plus the message
gathers) and how its design answers that.

The kernel is built with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, at its first launch, into ``build/`` at the repository
root, and loaded with ``ctypes`` (:mod:`repro_torch.kernels._build`).

:func:`ell_spmv` runs the kernel on CUDA tensors and the plain version
(:func:`repro_torch.kernels.ref.ell_spmv_ref`) on CPU tensors; on a CUDA
tensor it launches or raises.  :data:`launches` counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.vertex_program import PROCESS_FORMS, PROCESS_OPS
from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.ref import ell_spmv_ref

EDGE_OPS = ("msg_plus_edge", "msg_times_edge")  # the forms that read vals
# Codes passed to the C function; the orders match the enums in the source.
_OP_CODE = {op: i for i, op in enumerate(PROCESS_OPS)}
_REDUCE_CODE = {"add": 0, "min": 1, "max": 2}
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.int32: 2}
MAX_QUERY_TILE = 8
DEFAULT_BLOCK_ROWS = 8


def config_key(q: int, dtype: torch.dtype, reduce_kind: str,
               process_op: str) -> str:
  """The launch counter's key for one kernel instance and grid."""
  grid = "q1" if q == 1 else "qtiled"
  return f"{grid}/{str(dtype).replace('torch.', '')}/{reduce_kind}/{process_op}"


class LaunchCounter:
  """Kernel launches, counted where the wrapper launches the kernel, by
  :func:`config_key`: ``single`` for the Q = 1 grid, ``multi`` for the
  query-tiled grid."""

  def __init__(self):
    self.by_config: Dict[str, int] = {}

  def add(self, key: str) -> None:
    self.by_config[key] = self.by_config.get(key, 0) + 1

  @property
  def single(self) -> int:
    return sum(v for k, v in self.by_config.items() if k.startswith("q1/"))

  @property
  def multi(self) -> int:
    return sum(v for k, v in self.by_config.items()
               if k.startswith("qtiled/"))

  @property
  def total(self) -> int:
    return sum(self.by_config.values())

  def reset(self) -> None:
    self.by_config.clear()


launches = LaunchCounter()


def _bind(lib: ctypes.CDLL) -> None:
  fn = lib.graphmat_ell_spmv
  fn.argtypes = ([ctypes.c_void_p] * 7
                 + [ctypes.c_longlong] + [ctypes.c_int] * 7
                 + [ctypes.c_void_p])
  fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("ell_spmv.cu", _bind)


def plain_process(process_op: str):
  """The form :data:`PROCESS_FORMS` names, as :func:`ell_spmv_ref`'s
  ``process`` (whose edge values have no trailing query axis)."""
  form = PROCESS_FORMS[process_op]
  return lambda m, e, d: form(m, e[..., None], d)


def takes(msg: torch.Tensor, vals: torch.Tensor, process_op: str,
          reduce_kind: str) -> bool:
  """Whether the kernel takes messages ``msg`` ([n] or [n, Q]) with this
  form and reduce; the forms that read the edge need ``vals`` in ``msg``'s
  dtype."""
  return (process_op in PROCESS_FORMS and reduce_kind in _REDUCE_CODE
          and msg.ndim <= 2 and msg.dtype in _DTYPE_CODE
          and (process_op not in EDGE_OPS or vals.dtype == msg.dtype))


def _check(cond: bool, what: str) -> None:
  if not cond:
    raise ValueError(f"ell_spmv: {what}")


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor,
             msg: torch.Tensor, active: torch.Tensor, *, process_op: str,
             reduce_kind: str, block_rows: Optional[int] = None,
             block_queries: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
  """``(y [n_pad, Q], recv int8[n_pad])`` for one ELL block.

  Args:
    cols: int32[n_pad, W] source ids; vals [n_pad, W]; mask bool[n_pad, W].
    msg: [n_src, Q] messages (Q = 1 for a single query), float32, float16
      or int32; y has its dtype.
    active: bool[n_src] source frontier.
    process_op: a key of :data:`PROCESS_FORMS`; the edge forms need ``vals`` in
      ``msg``'s dtype.
    reduce_kind: add | min | max.
    block_rows: packed rows (warps) per thread block, 1..32.
    block_queries: query tile, 1..8 (default: the largest divisor of Q that
      is at most 8).
  """
  _check(process_op in PROCESS_FORMS, f"unknown process_op {process_op!r}")
  _check(reduce_kind in _REDUCE_CODE, f"reduce_kind {reduce_kind!r}")
  _check(cols.ndim == 2 and vals.shape == cols.shape
         and mask.shape == cols.shape, "cols, vals, mask must be [n_pad, W]")
  _check(msg.ndim == 2 and active.shape == (msg.shape[0],),
         "msg must be [n_src, Q] and active [n_src]")
  tensors = (cols, vals, mask, msg, active)
  if all(t.device.type == "cpu" for t in tensors):
    dprop = torch.zeros((cols.shape[0], 1), dtype=msg.dtype)
    return ell_spmv_ref(cols, vals, mask, msg, active, dprop,
                        process=plain_process(process_op), reduce_kind=reduce_kind)

  dev = cols.device
  _check(dev.type == "cuda" and all(t.device == dev for t in tensors),
         "all tensors must lie on one CUDA device")
  _check(cols.dtype == torch.int32, "cols must be int32")
  _check(mask.dtype == torch.bool and active.dtype == torch.bool,
         "mask and active must be bool")
  _check(msg.dtype in _DTYPE_CODE, f"msg dtype {msg.dtype} not supported")
  _check(process_op not in EDGE_OPS or vals.dtype == msg.dtype,
         f"{process_op} needs vals in msg's dtype {msg.dtype}")
  _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
  n_pad, width = cols.shape
  q = msg.shape[1]
  rows = DEFAULT_BLOCK_ROWS if block_rows is None else int(block_rows)
  _check(1 <= rows <= 32, f"block_rows={rows} must be in 1..32")
  tile = block_queries or _pick_query_tile(q)
  tile = min(int(tile), q)
  _check(1 <= tile <= MAX_QUERY_TILE,
         f"block_queries={tile} must be in 1..{MAX_QUERY_TILE}")

  lib = LIBRARY.load()
  y = torch.empty((n_pad, q), dtype=msg.dtype, device=dev)
  recv = torch.empty((n_pad,), dtype=torch.int8, device=dev)
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.graphmat_ell_spmv(
        cols.data_ptr(), vals.data_ptr(), mask.data_ptr(), msg.data_ptr(),
        active.data_ptr(), y.data_ptr(), recv.data_ptr(), n_pad, width, q,
        tile, rows, _DTYPE_CODE[msg.dtype], _REDUCE_CODE[reduce_kind],
        _OP_CODE[process_op], stream)
  LIBRARY.check(rc, "ell_spmv")
  launches.add(config_key(q, msg.dtype, reduce_kind, process_op))
  return y, recv


def _pick_query_tile(q: int, target: int = MAX_QUERY_TILE) -> int:
  """Largest divisor of ``q`` that is at most ``target`` (the query tile
  of the multi-query grid; ``kernels/ops.py::_pick_query_block`` in the
  reference, with the CUDA kernel's tile limit)."""
  return max(c for c in range(1, min(target, q) + 1) if q % c == 0)
