"""Graph containers (PyTorch port of :mod:`repro.core.graph`).

Frozen dataclasses of tensors with a ``.to(device)``.  The host-side
builders are the JAX package's numpy code, so the arrays they produce are
equal to the JAX builders' arrays; two dtypes differ on purpose:

* COO ``src``/``dst`` and ELL ``row_of``/``packed_of`` are int64, because
  torch scatters take int64 indices.  They are converted once here, never
  per superstep.
* ELL ``cols`` stays int32: the CUDA kernel reads it, and 4 bytes a slot is
  part of its memory bound.

Padded ELL rows map to vertex ``n`` in ``row_of``, as in the reference.
The port never scatters through ``row_of``: it un-permutes with the gather
``y_packed[packed_of]``, which cannot touch a padded row.

An ELL graph also carries, computed once where it is made, each packed
row's extent ``row_end`` (one past its last set slot) and whether the mask
is a prefix of every row (:func:`ell_extent`): the CUDA kernel reads no
slot beyond a row's extent, and no mask where it is a prefix.

Orientation: edges (src -> dst); pull-mode SpMV ``y[v] = ⊕ process(x[u],
w_uv, prop[v])`` over every edge ``(u, v)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

# Sentinel column index for padded ELL slots / padded COO entries.
PAD = 0


@dataclasses.dataclass(frozen=True)
class CooGraph:
  """Destination-sorted COO padded to ``capacity``; ``emask`` marks real
  edges and padded entries point at vertex 0 (src) / ``n-1`` (dst)."""

  n: int
  src: torch.Tensor      # int64[capacity]
  dst: torch.Tensor      # int64[capacity], non-decreasing over real edges
  w: torch.Tensor        # [capacity] edge values
  emask: torch.Tensor    # bool[capacity]
  out_deg: torch.Tensor  # int32[n]
  in_deg: torch.Tensor   # int32[n]

  @property
  def capacity(self) -> int:
    return int(self.src.shape[0])

  @property
  def num_edges(self) -> torch.Tensor:
    return self.emask.sum(dtype=torch.int32)

  @property
  def device(self) -> torch.device:
    return self.src.device

  def arrays(self) -> Dict[str, torch.Tensor]:
    return {f: getattr(self, f) for f in
            ("src", "dst", "w", "emask", "out_deg", "in_deg")}

  def to(self, device: DeviceLike) -> "CooGraph":
    dev = resolve_device(device)
    return CooGraph(self.n, **{k: v.to(dev) for k, v in self.arrays().items()})


def ell_extent(mask) -> Tuple[np.ndarray, bool]:
  """``(row_end, mask_prefix)`` of a ``bool[n_pad, W]`` mask (numpy or a
  tensor, read back to the host once).

  ``row_end[r]`` (int32) is one past the last set slot of row r, 0 for an
  empty row; ``mask_prefix`` says the set slots of every row are exactly
  ``[0, row_end)``.
  """
  if isinstance(mask, torch.Tensor):
    mask = mask.cpu().numpy()
  mask = np.asarray(mask, bool)
  width = mask.shape[1]
  last = width - np.argmax(mask[:, ::-1], axis=1) if width else 0
  row_end = np.where(mask.any(axis=1), last, 0).astype(np.int32)
  return row_end, bool((mask.sum(axis=1) == row_end).all())


@dataclasses.dataclass(frozen=True)
class EllGraph:
  """Degree-sorted ELL rows plus a COO spill for rows wider than ``width``.

  ``cols[r, s]`` is the source of the s-th incoming edge of packed row r,
  ``row_of[r]`` the vertex of packed row r (``n`` for padding rows), and
  ``packed_of[v]`` the packed row of vertex v.  ``row_end`` and
  ``mask_prefix`` are the mask's :func:`ell_extent`.
  """

  n: int
  width: int
  cols: torch.Tensor       # int32[n_pad, width]
  vals: torch.Tensor       # [n_pad, width]
  mask: torch.Tensor       # bool[n_pad, width]
  row_of: torch.Tensor     # int64[n_pad]
  packed_of: torch.Tensor  # int64[n]
  spill: Optional[CooGraph]
  row_end: torch.Tensor    # int32[n_pad]
  mask_prefix: bool

  @property
  def n_pad(self) -> int:
    return int(self.cols.shape[0])

  @property
  def device(self) -> torch.device:
    return self.cols.device

  def arrays(self) -> Dict[str, torch.Tensor]:
    out = {f: getattr(self, f) for f in
           ("cols", "vals", "mask", "row_of", "packed_of")}
    if self.spill is not None:
      out.update({f"spill.{k}": v for k, v in self.spill.arrays().items()})
    return out

  def to(self, device: DeviceLike) -> "EllGraph":
    dev = resolve_device(device)
    return EllGraph(
        self.n, self.width, self.cols.to(dev), self.vals.to(dev),
        self.mask.to(dev), self.row_of.to(dev), self.packed_of.to(dev),
        None if self.spill is None else self.spill.to(dev),
        self.row_end.to(dev), self.mask_prefix)


@dataclasses.dataclass(frozen=True)
class DenseGraph:
  """O(n²) dense adjacency, the test oracle: ``struct[v, u]`` marks edge
  u -> v with value ``vals[v, u]``."""

  n: int
  vals: torch.Tensor     # [n, n]
  struct: torch.Tensor   # bool[n, n]

  @property
  def device(self) -> torch.device:
    return self.vals.device

  def arrays(self) -> Dict[str, torch.Tensor]:
    return {"vals": self.vals, "struct": self.struct}

  def to(self, device: DeviceLike) -> "DenseGraph":
    dev = resolve_device(device)
    return DenseGraph(self.n, self.vals.to(dev), self.struct.to(dev))


# ---------------------------------------------------------------------------
# Carrying a graph across from numpy arrays
# ---------------------------------------------------------------------------

_INDEX_DTYPES = {"src": torch.int64, "dst": torch.int64, "cols": torch.int32,
                 "row_of": torch.int64, "packed_of": torch.int64,
                 "out_deg": torch.int32, "in_deg": torch.int32,
                 "emask": torch.bool, "mask": torch.bool,
                 "struct": torch.bool}


def _tensor(name: str, a: np.ndarray, dev: torch.device) -> torch.Tensor:
  a = np.ascontiguousarray(a)
  if not a.flags.writeable:  # e.g. np.asarray of a JAX array
    a = a.copy()
  t = torch.from_numpy(a)
  if name in _INDEX_DTYPES:
    t = t.to(_INDEX_DTYPES[name])
  return t.to(dev)


def from_arrays(kind: str, n: int, arrays: Dict[str, np.ndarray],
                width: Optional[int] = None,
                spill: Optional[Dict[str, np.ndarray]] = None,
                device: DeviceLike = "cuda"):
  """Build the port's container from a graph's fields as numpy arrays.

  ``kind`` is ``"coo"``, ``"ell"`` or ``"dense"``; ``arrays`` holds the
  fields of the JAX package's container of that kind under the same names
  (for example ``np.asarray(g.cols)``), and ``spill`` the fields of an ELL
  graph's COO spill.  This is how a graph built by the JAX package is
  carried across to the port.
  """
  dev = resolve_device(device)
  t = {k: _tensor(k, v, dev) for k, v in arrays.items()}
  if kind == "coo":
    return CooGraph(n, t["src"], t["dst"], t["w"], t["emask"], t["out_deg"],
                    t["in_deg"])
  if kind == "ell":
    w = int(width) if width is not None else int(t["cols"].shape[1])
    sp = None if spill is None else from_arrays("coo", n, spill, device=dev)
    row_end, prefix = ell_extent(arrays["mask"])
    return EllGraph(n, w, t["cols"], t["vals"], t["mask"], t["row_of"],
                    t["packed_of"], sp, torch.from_numpy(row_end).to(dev),
                    prefix)
  if kind == "dense":
    return DenseGraph(n, t["vals"], t["struct"])
  raise ValueError(f"unknown graph kind {kind!r}")


# ---------------------------------------------------------------------------
# Host-side constructors (numpy, as in the reference)
# ---------------------------------------------------------------------------


def _as_np_edges(src, dst, w, n, dtype):
  src = np.asarray(src, np.int32)
  dst = np.asarray(dst, np.int32)
  if w is None:
    w = np.ones(src.shape[0], dtype)
  else:
    w = np.asarray(w, dtype)
  if not src.shape == dst.shape == w.shape:
    raise ValueError("src, dst and w must have one shape")
  if src.size and not (src.max(initial=0) < n and dst.max(initial=0) < n):
    raise ValueError(f"vertex ids must be < n={n}")
  return src, dst, w


def coo_arrays(src, dst, w=None, *, n: int, edge_dtype=np.float32,
               capacity: Optional[int] = None, sort: bool = True
               ) -> Dict[str, np.ndarray]:
  """The fields of a destination-sorted COO graph, as numpy arrays."""
  dt = np.dtype(edge_dtype)
  src, dst, w = _as_np_edges(src, dst, w, n, dt)
  if sort and src.size:
    order = np.argsort(dst, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
  e = src.shape[0]
  cap = capacity or max(e, 1)
  if cap < e:
    raise ValueError(f"capacity {cap} < num edges {e}")
  pad = cap - e
  return {
      "src": np.concatenate([src, np.full(pad, PAD, np.int32)]),
      # Padded dst = n-1 keeps the array destination-sorted.
      "dst": np.concatenate([dst, np.full(pad, max(n - 1, 0), np.int32)]),
      "w": np.concatenate([w, np.zeros(pad, dt)]),
      "emask": np.concatenate([np.ones(e, bool), np.zeros(pad, bool)]),
      "out_deg": np.bincount(src, minlength=n).astype(np.int32),
      "in_deg": np.bincount(dst, minlength=n).astype(np.int32),
  }


def build_coo(src, dst, w=None, *, n: int, edge_dtype=np.float32,
              capacity: Optional[int] = None, sort: bool = True,
              device: DeviceLike = "cuda") -> CooGraph:
  """Build a destination-sorted :class:`CooGraph` from host edge arrays."""
  return from_arrays("coo", n, coo_arrays(
      src, dst, w, n=n, edge_dtype=edge_dtype, capacity=capacity, sort=sort),
      device=device)


def ell_arrays(src, dst, w=None, *, n: int, edge_dtype=np.float32,
               width: Optional[int] = None, row_block: int = 8,
               spill_frac_cap: float = 1.0
               ) -> Tuple[Dict[str, np.ndarray], Optional[Dict], int]:
  """(ELL fields, spill COO fields or None, width) as numpy arrays."""
  dt = np.dtype(edge_dtype)
  src, dst, w = _as_np_edges(src, dst, w, n, dt)
  in_deg = np.bincount(dst, minlength=n).astype(np.int32)
  if width is None:
    nz = in_deg[in_deg > 0]
    q = int(np.percentile(nz, 95)) if nz.size else 1
    width = max(8, int(np.ceil(q / 8)) * 8)

  perm = np.argsort(-in_deg, kind="stable").astype(np.int32)  # packed -> vid
  inv = np.empty(n, np.int32)
  inv[perm] = np.arange(n, dtype=np.int32)                    # vid -> packed

  n_pad = int(np.ceil(n / row_block)) * row_block
  cols = np.full((n_pad, width), PAD, np.int32)
  vals = np.zeros((n_pad, width), dt)
  mask = np.zeros((n_pad, width), bool)

  order = np.argsort(dst, kind="stable")
  s_src, s_dst, s_w = src[order], dst[order], w[order]
  if s_dst.size:
    starts = np.searchsorted(s_dst, s_dst)  # first index of this dst run
    slot = np.arange(s_dst.shape[0]) - starts
  else:
    slot = np.zeros(0, np.int64)
  fits = slot < width
  r = inv[s_dst[fits]]
  cols[r, slot[fits]] = s_src[fits]
  vals[r, slot[fits]] = s_w[fits]
  mask[r, slot[fits]] = True

  spill_src, spill_dst, spill_w = s_src[~fits], s_dst[~fits], s_w[~fits]
  total = max(src.shape[0], 1)
  if spill_src.shape[0] > spill_frac_cap * total:
    raise ValueError(f"{spill_src.shape[0]}/{total} edges spill; raise width")
  spill = None
  if spill_src.shape[0]:
    spill = coo_arrays(spill_src, spill_dst, spill_w, n=n, edge_dtype=dt)

  row_of = np.concatenate(
      [perm, np.full(n_pad - n, n, np.int32)]) if n_pad > n else perm
  return ({"cols": cols, "vals": vals, "mask": mask, "row_of": row_of,
           "packed_of": inv}, spill, int(width))


def build_ell(src, dst, w=None, *, n: int, edge_dtype=np.float32,
              width: Optional[int] = None, row_block: int = 8,
              spill_frac_cap: float = 1.0,
              device: DeviceLike = "cuda") -> EllGraph:
  """Build a degree-sorted :class:`EllGraph` (+ spill) from host edges.

  ``width`` defaults to the 95th-percentile in-degree rounded up to a
  multiple of 8; edges of wider rows spill to COO.
  """
  arrays, spill, width = ell_arrays(
      src, dst, w, n=n, edge_dtype=edge_dtype, width=width,
      row_block=row_block, spill_frac_cap=spill_frac_cap)
  return from_arrays("ell", n, arrays, width=width, spill=spill,
                     device=device)


def dense_adjacency(src, dst, w=None, *, n: int, edge_dtype=np.float32
                    ) -> Tuple[np.ndarray, np.ndarray]:
  """Small-graph oracle: (A[dst, src] values, boolean structure), numpy."""
  dt = np.dtype(edge_dtype)
  src, dst, w = _as_np_edges(src, dst, w, n, dt)
  a = np.zeros((n, n), dt)
  s = np.zeros((n, n), bool)
  a[dst, src] = w
  s[dst, src] = True
  return a, s


def build_dense(src, dst, w=None, *, n: int, edge_dtype=np.float32,
                device: DeviceLike = "cuda") -> DenseGraph:
  """Build a :class:`DenseGraph` from host edge arrays."""
  vals, struct = dense_adjacency(src, dst, w, n=n, edge_dtype=edge_dtype)
  return from_arrays("dense", n, {"vals": vals, "struct": struct},
                     device=device)


def coo_from_ell(g: EllGraph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Host-side: recover (src, dst, w) from an EllGraph."""
  cols = g.cols.cpu().numpy()
  vals = g.vals.cpu().numpy()
  mask = g.mask.cpu().numpy()
  row_of = g.row_of.cpu().numpy()
  rr, ss = np.nonzero(mask)
  src = cols[rr, ss]
  dst = row_of[rr]
  w = vals[rr, ss]
  if g.spill is not None:
    em = g.spill.emask.cpu().numpy()
    src = np.concatenate([src, g.spill.src.cpu().numpy()[em]])
    dst = np.concatenate([dst, g.spill.dst.cpu().numpy()[em]])
    w = np.concatenate([w, g.spill.w.cpu().numpy()[em]])
  return src, dst, w
