"""Generalized SpMV backends (PyTorch port of :mod:`repro.core.spmv`).

Every backend computes, for each edge ``(u -> v)`` with ``active[u]``::

    y[v] = REDUCE(y[v], PROCESS_MESSAGE(msg[u], w_uv, prop[v]))

and ``recv[v]``, whether v received at least one message.  Inactive sources
contribute the reduce identity.

Backends:
  * ``spmv_dense``     — O(n²) masked oracle for tests.
  * ``spmv_coo``       — gather + ``scatter_reduce_`` over the dst-sorted
                         edge list (a segmented scan for generic monoids).
  * ``spmv_coo_tiled`` — the same, one equal-size edge tile at a time
                         (scatter-fast monoids only).
  * ``spmv_ell``       — degree-sorted ELL rows: gather + axis-1 reduce, hub
                         spill edges folded in through the COO path.

The hand-written CUDA kernel for the ELL rows is reached through the
``cuda_ell`` backend (:mod:`repro_torch.kernels.ops`).  On CUDA tensors the
COO calls (``spmv_coo``, ``spmv_coo_tiled``, the spill merge) run the
hand-written segmented-reduction kernel wherever
:func:`repro_torch.kernels.coo_spmv.route` takes them; the gather and
scatter chain here is its plain version, and runs every other call.

Reductions: add/min/max/any/all run as scatter (COO) or axis (dense, ELL)
fast paths.  The ``generic`` reduce (an arbitrary monoid given as a pytree
function, as triangle counting's bitwise-or) runs as a halving tree over
the slot axis (dense, ELL) and as a log-step segmented inclusive scan over
the dst-sorted edges (COO), as the reference does.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import _tree, tracing
from repro_torch.core import graph as graphlib
from repro_torch.core import semiring as sr
from repro_torch.core.vertex_program import GraphProgram

PyTree = Any

_SCATTER_FAST = {"add", "min", "max", "any", "all"}
_SCATTER_REDUCE = {"add": "sum", "min": "amin", "max": "amax",
                   "any": "amax", "all": "amin"}


def _tree_gather(tree: PyTree, idx: torch.Tensor) -> PyTree:
  """Gather rows ``tree[idx]`` per leaf (idx may be multi-dimensional)."""
  return _tree.tree_map(lambda x: x[idx], tree)


def _bcast_mask(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
  return mask.reshape(mask.shape + (1,) * (leaf.ndim - mask.ndim))


def _tree_where(mask: torch.Tensor, a: PyTree, b: PyTree) -> PyTree:
  """Leafwise ``where(mask, a, b)``; ``b``'s leaves may be Python scalars."""
  return _tree.tree_map(
      lambda x, y: torch.where(_bcast_mask(mask, x), x, y), a, b)


def _idents(program: GraphProgram, r: PyTree) -> PyTree:
  """Pytree of Python-scalar reduce identities matching ``r``."""
  if program.reduce_identity is not None:
    return program.reduce_identity
  return _tree.tree_map(
      lambda x: sr._identity_for(program.reduce_kind, x.dtype), r)


def _edge_values(e: torch.Tensor, msg: PyTree, batch_dims: int
                 ) -> torch.Tensor:
  """Edge values with one trailing unit axis per message payload axis, so
  a broadcasting ``process_message`` sees ``m + e`` lane by lane."""
  payload = _tree.tree_leaves(msg)[0].ndim - batch_dims
  return e.reshape(e.shape + (1,) * payload)


def _axis_reduce(x: torch.Tensor, kind: str, dim: int) -> torch.Tensor:
  if kind == "add":
    return x.sum(dim=dim, dtype=x.dtype)
  if kind == "min":
    return x.amin(dim=dim)
  if kind == "max":
    return x.amax(dim=dim)
  if kind == "any":
    return x.any(dim=dim)
  return x.all(dim=dim)


def _axis_tree_reduce(tree: PyTree, red, idents: PyTree, dim: int) -> PyTree:
  """Reduce ``dim`` with a pytree-level binary monoid ``red``: pad the axis
  with the identities (Python scalars) to a power of two, then halve it
  log₂ times (the reference's ``_axis_tree_reduce``)."""
  size = _tree.tree_leaves(tree)[0].shape[dim]
  pow2 = 1
  while pow2 < size:
    pow2 *= 2
  if pow2 != size:
    def pad(x, i):
      shape = list(x.shape)
      shape[dim] = pow2 - size
      return torch.cat(
          [x, torch.full(shape, i, dtype=x.dtype, device=x.device)], dim=dim)
    tree = _tree.tree_map(pad, tree, idents)
  while pow2 > 1:
    pow2 //= 2
    tree = red(_tree.tree_map(lambda x: x.narrow(dim, 0, pow2), tree),
               _tree.tree_map(lambda x: x.narrow(dim, pow2, pow2), tree))
  return _tree.tree_map(lambda x: x.squeeze(dim), tree)


def _reduce_rows(r: PyTree, program: GraphProgram, dim: int) -> PyTree:
  """The reduce over axis ``dim`` of identity-masked ``r``."""
  if program.reduce_kind in _SCATTER_FAST:
    return _tree.tree_map(
        lambda x: _axis_reduce(x, program.reduce_kind, dim), r)
  return _axis_tree_reduce(r, program.reduce_fn(), _idents(program, r), dim)


def mask_inert(msg: PyTree, active: torch.Tensor,
               program: GraphProgram) -> PyTree:
  """Replace inactive lanes of ``msg`` with the program's inert message.

  ``active`` may be ``bool[n]`` or ``bool[n, Q]`` (per-query lanes).
  """
  if program.inert_message is None:
    raise ValueError(
        f"program {program.name!r} has no inert_message; batched execution "
        "requires one (see GraphProgram.inert_message)")
  # Python scalars, not device tensors: copying one to the card each
  # superstep would wait on the stream.
  return _tree_where(active, msg, program.inert_message)


# ---------------------------------------------------------------------------
# Dense oracle
# ---------------------------------------------------------------------------


def spmv_dense(adj_vals: torch.Tensor, adj_struct: torch.Tensor, msg: PyTree,
               active: torch.Tensor, dst_prop: PyTree, program: GraphProgram
               ) -> Tuple[PyTree, torch.Tensor]:
  """O(n²) reference: ``adj_struct[v, u]`` marks edge u -> v with value
  ``adj_vals[v, u]``."""
  n = adj_struct.shape[0]
  msg_b = _tree.tree_map(lambda x: x[None].expand((n,) + x.shape), msg)
  prop_b = _tree.tree_map(
      lambda x: x[:, None].expand((x.shape[0], n) + x.shape[1:]), dst_prop)
  r = program.process_message(msg_b, _edge_values(adj_vals, msg_b, 2), prop_b)
  valid = adj_struct & active[None, :]
  r = _tree_where(valid, r, _idents(program, r))
  return _reduce_rows(r, program, 1), valid.any(dim=1)


# ---------------------------------------------------------------------------
# COO: gather + scatter reduce
# ---------------------------------------------------------------------------


def _scatter_into(out: torch.Tensor, dst: torch.Tensor, leaf: torch.Tensor,
                  kind: str) -> torch.Tensor:
  """``out[dst[i]] ⊕= leaf[i]`` in place.  Bool leaves (any/all) go through
  int32, which ``scatter_reduce_`` takes on every device.  Float16 and
  bfloat16 sums go through float32 and round once, as the ELL kernel and
  ``torch.sum`` do: CUDA's scatter adds each term in the half type, and a
  hub's sum stops growing once its ulp exceeds the terms."""
  idx = dst.reshape(dst.shape + (1,) * (leaf.ndim - 1)).expand_as(leaf)
  if leaf.dtype == torch.bool or (
      kind == "add" and leaf.dtype in (torch.float16, torch.bfloat16)):
    wide = torch.int32 if leaf.dtype == torch.bool else torch.float32
    acc = out.to(wide).scatter_reduce_(0, idx, leaf.to(wide),
                                       _SCATTER_REDUCE[kind])
    out.copy_(acc.to(out.dtype))
    return out
  return out.scatter_reduce_(0, idx, leaf, _SCATTER_REDUCE[kind])


def _recv_scatter(recv: torch.Tensor, dst: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
  """``recv[v] |= any(valid[e] for e into v)``, as an int32 count."""
  return recv.index_add_(0, dst, valid.to(torch.int32))


def _coo_process(g: graphlib.CooGraph, lo: int, hi: int, msg: PyTree,
                 active: torch.Tensor, dst_prop: PyTree,
                 program: GraphProgram):
  src, dst = g.src[lo:hi], g.dst[lo:hi]
  m = _tree_gather(msg, src)                          # [E, ...]
  if program.process_reads_dst:
    dp = _tree_gather(dst_prop, dst)
  else:
    dp = _tree.tree_map(
        lambda x: x[:1].expand((src.shape[0],) + x.shape[1:]), dst_prop)
  r = program.process_message(m, _edge_values(g.w[lo:hi], m, 1), dp)
  valid = g.emask[lo:hi] & active[src]
  return _tree_where(valid, r, _idents(program, r)), valid, dst


def _empty_out(program: GraphProgram, r: PyTree, n: int) -> PyTree:
  return _tree.tree_map(
      lambda x, i: torch.full((n,) + x.shape[1:], i, dtype=x.dtype,
                              device=x.device), r, _idents(program, r))


def _segment_reduce_scan(r: PyTree, dst: torch.Tensor, n: int, red,
                         idents: PyTree) -> PyTree:
  """Segment totals of a generic monoid over dst-sorted edges.

  A log-step (Hillis–Steele) segmented inclusive scan: the carry is (start
  flag, value); at step ``s`` each edge combines with the edge ``s`` places
  before it unless a segment starts between them (its flag is set), and
  the flags OR together.  After ⌈log₂ E⌉ steps each segment's last edge
  holds the segment's total, which is written into ``y[dst]``.  Each step
  is whole-tensor work on the ``[E, ...]`` leaves, with no host read.
  ``r``'s leaves are overwritten (the caller's fresh, identity-masked
  values).  Requires ``dst`` non-decreasing, as ``coo_arrays`` sorts it.
  """
  e = dst.shape[0]
  flags = torch.ones((e,), dtype=torch.bool, device=dst.device)
  flags[1:] = dst[1:] != dst[:-1]
  s = 1
  while s < e:
    comb = red(_tree.tree_map(lambda x: x[:-s], r),
               _tree.tree_map(lambda x: x[s:], r))
    later = flags[s:]
    for x, c in zip(_tree.tree_leaves(r), _tree.tree_leaves(comb)):
      x[s:] = torch.where(_bcast_mask(later, c), x[s:], c)
    del comb
    flags = torch.cat([flags[:s], later | flags[:-s]])
    s *= 2
  last = torch.ones((e,), dtype=torch.bool, device=dst.device)
  last[:-1] = dst[:-1] != dst[1:]
  tgt = dst[last]

  def scatter(leaf, ident):
    out = torch.full((n,) + leaf.shape[1:], ident, dtype=leaf.dtype,
                     device=leaf.device)
    out[tgt] = leaf[last]
    return out
  return _tree.tree_map(scatter, r, idents)


def spmv_coo(g: graphlib.CooGraph, msg: PyTree, active: torch.Tensor,
             dst_prop: PyTree, program: GraphProgram,
             with_recv: bool = True
             ) -> Tuple[PyTree, Optional[torch.Tensor]]:
  from repro_torch.kernels import coo_spmv  # lazy: kernels import core
  call = coo_spmv.route(g, msg, active, dst_prop, program)
  if call is not None:
    return coo_spmv.spmv(call, g, active, with_recv)
  return _spmv_coo_torch(g, msg, active, dst_prop, program, with_recv)


def _spmv_coo_torch(g: graphlib.CooGraph, msg: PyTree, active: torch.Tensor,
                    dst_prop: PyTree, program: GraphProgram,
                    with_recv: bool = True
                    ) -> Tuple[PyTree, Optional[torch.Tensor]]:
  """:func:`spmv_coo` in PyTorch: the gather, the process over the edges,
  the scatter (the kernel's plain version)."""
  r, valid, dst = _coo_process(g, 0, g.capacity, msg, active, dst_prop,
                               program)
  if program.reduce_kind in _SCATTER_FAST:
    y = _tree.tree_map(
        lambda out, leaf: _scatter_into(out, dst, leaf, program.reduce_kind),
        _empty_out(program, r, g.n), r)
  else:
    y = _segment_reduce_scan(r, dst, g.n, program.reduce_fn(),
                             _idents(program, r))
  if not with_recv:
    return y, None
  recv = torch.zeros((g.n,), dtype=torch.int32, device=dst.device)
  return y, _recv_scatter(recv, dst, valid) > 0


# ---------------------------------------------------------------------------
# Partitioned COO: equal-size edge tiles
# ---------------------------------------------------------------------------

TILE_EDGES = 4096
MAX_TILES = 64


def default_num_tiles(capacity: int) -> int:
  """The paper's "many more partitions than threads" sizing for edge tiles."""
  return max(1, min(MAX_TILES, -(-capacity // TILE_EDGES)))


def spmv_coo_tiled(g: graphlib.CooGraph, msg: PyTree, active: torch.Tensor,
                   dst_prop: PyTree, program: GraphProgram, *,
                   num_tiles: Optional[int] = None,
                   with_recv: bool = True
                   ) -> Tuple[PyTree, Optional[torch.Tensor]]:
  """Row-partitioned COO: the dst-sorted edge array is cut into
  ``num_tiles`` equal-size contiguous tiles, each reduced into the output
  with the monoid's scatter.

  For min/max/any/all the result is bitwise equal to :func:`spmv_coo`.  For
  add the sums may differ in the last bits on the PyTorch path: CUDA
  scatters add with atomics in no fixed order.  A call that the COO kernel
  takes (:func:`repro_torch.kernels.coo_spmv.route`) runs as
  :func:`spmv_coo` does, whose tiles are the kernel's own: ``num_tiles``
  then does not change the result, and add sums equal :func:`spmv_coo`'s
  bit for bit.
  """
  if program.reduce_kind not in _SCATTER_FAST:
    raise ValueError(
        f"spmv_coo_tiled requires a scatter-fast reduce, got "
        f"{program.reduce_kind!r}")
  from repro_torch.kernels import coo_spmv  # lazy: kernels import core
  call = coo_spmv.route(g, msg, active, dst_prop, program)
  if call is not None:
    return coo_spmv.spmv(call, g, active, with_recv)
  return _spmv_coo_tiled_torch(g, msg, active, dst_prop, program, num_tiles,
                               with_recv)


def _spmv_coo_tiled_torch(g: graphlib.CooGraph, msg: PyTree,
                          active: torch.Tensor, dst_prop: PyTree,
                          program: GraphProgram, num_tiles: Optional[int],
                          with_recv: bool
                          ) -> Tuple[PyTree, Optional[torch.Tensor]]:
  """:func:`spmv_coo_tiled` in PyTorch, tile by tile (the kernel's plain
  version)."""
  cap = g.capacity
  t = int(num_tiles) if num_tiles else default_num_tiles(cap)
  t = max(1, min(t, cap))
  ts = -(-cap // t)
  y = recv = None
  for lo in range(0, cap, ts):
    r, valid, dst = _coo_process(g, lo, min(lo + ts, cap), msg, active,
                                 dst_prop, program)
    if y is None:
      y = _empty_out(program, r, g.n)
      if with_recv:
        recv = torch.zeros((g.n,), dtype=torch.int32, device=dst.device)
    y = _tree.tree_map(
        lambda out, leaf: _scatter_into(out, dst, leaf, program.reduce_kind),
        y, r)
    if with_recv:
      _recv_scatter(recv, dst, valid)
  return y, (recv > 0 if with_recv else None)


# ---------------------------------------------------------------------------
# ELL: gather + axis-1 reduce (+ spill via COO)
# ---------------------------------------------------------------------------


def _ell_packed_compute(g: graphlib.EllGraph, msg: PyTree,
                        active: torch.Tensor, dst_prop: PyTree,
                        program: GraphProgram):
  """Per-packed-row (y_packed, recv_packed) on the ELL block."""
  m = _tree_gather(msg, g.cols)                       # [n_pad, W, ...]
  valid = g.mask & active[g.cols]
  shape = tuple(g.cols.shape)
  if program.process_reads_dst:
    safe_rows = g.row_of.clamp(max=g.n - 1)
    dp = _tree.tree_map(
        lambda x: x[safe_rows][:, None].expand(shape + x.shape[1:]),
        dst_prop)
  else:
    dp = _tree.tree_map(
        lambda x: x[:1][:, None].expand(shape + x.shape[1:]), dst_prop)
  r = program.process_message(m, _edge_values(g.vals, m, 2), dp)
  r = _tree_where(valid, r, _idents(program, r))
  return _reduce_rows(r, program, 1), valid.any(dim=1)


def _unpermute(g: graphlib.EllGraph, y_packed: PyTree,
               recv_packed: torch.Tensor) -> Tuple[PyTree, torch.Tensor]:
  """Packed rows back to vertex order: ``y[v] = y_packed[packed_of[v]]``.

  The reference scatters through ``row_of`` and drops the padded rows; the
  gather through the inverse permutation gives the same values and never
  indexes a padded row.
  """
  y = _tree_gather(y_packed, g.packed_of)
  return y, recv_packed[g.packed_of]


def merge_spill(g: graphlib.EllGraph, y: PyTree, recv: torch.Tensor,
                msg: PyTree, active: torch.Tensor, dst_prop: PyTree,
                program: GraphProgram, process=None
                ) -> Tuple[PyTree, torch.Tensor]:
  """Fold the hub rows' spilled edges into the ELL result through COO.

  Where the COO kernel takes the call, it folds the spilled runs into
  ``y`` and ``recv`` in place (the ELL paths pass tensors of their own).
  ``process``: the process the caller resolved for the ELL rows
  (``process_expr.for_program``'s answer), not resolved again."""
  if g.spill is None:
    return y, recv
  from repro_torch.kernels import coo_spmv  # lazy: kernels import core
  with tracing.span(tracing.SPILL):
    call = coo_spmv.route(g.spill, msg, active, dst_prop, program, process)
    if call is not None:
      return coo_spmv.merge(call, g.spill, active, y, recv)
    y_s, recv_s = _spmv_coo_torch(g.spill, msg, active, dst_prop, program)
    red = program.reduce_fn()
    y = _tree_where(recv_s, _tree_where(recv, red(y, y_s), y_s), y)
    return y, recv | recv_s


def spmv_ell(g: graphlib.EllGraph, msg: PyTree, active: torch.Tensor,
             dst_prop: PyTree, program: GraphProgram,
             with_recv: bool = True
             ) -> Tuple[PyTree, Optional[torch.Tensor]]:
  y_packed, recv_packed = _ell_packed_compute(g, msg, active, dst_prop,
                                              program)
  y, recv = _unpermute(g, y_packed, recv_packed)
  y, recv = merge_spill(g, y, recv, msg, active, dst_prop, program)
  return y, (recv if with_recv else None)


# ---------------------------------------------------------------------------
# Dispatch (plan-based: repro_torch.core.backends owns the registry)
# ---------------------------------------------------------------------------


def spmv(graph, msg: PyTree, active: torch.Tensor, dst_prop: PyTree,
         program: GraphProgram, *, backend=None,
         with_recv: bool = True) -> Tuple[PyTree, Optional[torch.Tensor]]:
  """Generalized SpMV dispatcher: ``backend`` is a
  :class:`repro_torch.core.backends.Plan`, a registered backend name, or
  None/"auto" for structural selection."""
  from repro_torch.core import backends as backends_lib  # lazy: import cycle
  plan = backends_lib.as_plan(backend)
  impl = backends_lib.resolve(plan, graph, msg, dst_prop, program)
  with tracing.span(impl.span):
    return impl.execute(graph, msg, active, dst_prop, program, plan,
                        with_recv)
