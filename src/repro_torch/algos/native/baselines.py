"""Native torch baselines: straight gathers plus ``index_add_`` /
``scatter_reduce_`` over edge tensors.

Each function takes its edges (and other arrays) as tensors or numpy
arrays and runs on ``device`` (``"cuda"`` unless the caller asks for the
CPU); arrays are moved there once.  Edge ids are best given as int64 on the
device, which makes that move free.  BFS and SSSP read their ``changed``
flag on the host once an iteration, as the reference's ``while_loop``
tests it each iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.algos.triangle_count import bit_values, n_words, popcount32

UNREACHED = 0x7FFFFFF0


def _on(device: DeviceLike, *arrays):
  dev = resolve_device(device)
  return [(a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
           ).to(dev) for a in arrays]


def _ids(t: torch.Tensor) -> torch.Tensor:
  return t.to(torch.int64)


def native_pagerank(src, dst, out_deg, n: int, num_iters: int = 20,
                    r: float = 0.15, *, device: DeviceLike = "cuda"
                    ) -> torch.Tensor:
  """Power iteration by gather and ``index_add_``; ranks float32 [n].
  As in GraphMat (the paper's Algorithm 2), only vertices that receive a
  message apply the update: the others keep their initial rank."""
  src, dst, out_deg = _on(device, src, dst, out_deg)
  src, dst = _ids(src), _ids(dst)
  inv_deg = 1.0 / out_deg.to(torch.float32).clamp(min=1.0)
  recv = torch.zeros((n,), dtype=torch.bool, device=src.device)
  recv[dst] = True
  rank = torch.ones((n,), dtype=torch.float32, device=src.device)
  for _ in range(num_iters):
    agg = torch.zeros_like(rank).index_add_(0, dst, (rank * inv_deg)[src])
    rank = torch.where(recv, r + (1.0 - r) * agg, rank)
  return rank


def native_bfs(src, dst, n: int, root: int, max_iters: int = 0x7FFFFFF0, *,
               device: DeviceLike = "cuda") -> torch.Tensor:
  """int32 hop distances [n] (UNREACHED where unreachable)."""
  src, dst = (_ids(t) for t in _on(device, src, dst))
  dist = torch.full((n,), UNREACHED, dtype=torch.int32, device=src.device)
  dist[root] = 0
  it, changed = 0, True
  while changed and it < max_iters:
    ds = dist[src]
    cand = torch.where(ds < UNREACHED, ds + 1, UNREACHED)
    nd = dist.scatter_reduce(0, dst, cand, "amin")
    changed = bool((nd != dist).any())
    dist, it = nd, it + 1
  return dist


def native_sssp(src, dst, w, n: int, source: int,
                max_iters: int = 0x7FFFFFF0, *,
                device: DeviceLike = "cuda") -> torch.Tensor:
  """float32 Bellman-Ford distances [n] (inf where unreachable)."""
  src, dst, w = _on(device, src, dst, w)
  src, dst = _ids(src), _ids(dst)
  dist = torch.full((n,), float("inf"), dtype=torch.float32,
                    device=src.device)
  dist[source] = 0.0
  it, changed = 0, True
  while changed and it < max_iters:
    nd = dist.scatter_reduce(0, dst, dist[src] + w, "amin")
    changed = bool((nd != dist).any())
    dist, it = nd, it + 1
  return dist


def native_tc(src, dst, n: int, *, device: DeviceLike = "cuda"
              ) -> torch.Tensor:
  """Bitmap intersection per DAG edge: Σ popcount(out(u) & out(v)), an
  exact int64 scalar.

  Requires deduped edges (``dag_orient`` guarantees it): then every
  (row, word, bit) target is set once and ``index_put_(accumulate=True)``
  of int32 bit values is an exact bitwise OR.
  """
  src, dst = (_ids(t) for t in _on(device, src, dst))
  bits = torch.zeros((n, n_words(n)), dtype=torch.int32, device=src.device)
  bits.index_put_((src, dst // 32), bit_values(src.device)[dst % 32],
                  accumulate=True)
  inter = bits[src]
  inter &= bits[dst]
  return popcount32(inter).sum(dtype=torch.int64)


def native_cf(users, items_g, ratings, n: int, k: int, num_iters: int = 10,
              gamma: float = 5e-4, lam: float = 0.05, *, p0,
              device: DeviceLike = "cuda") -> torch.Tensor:
  """Two-phase GD sweeps with raw gathers and ``index_add_``; the factors
  [n, K] from the initial ``p0`` [n, K].  ``items_g`` are item vertex ids
  already offset into [U, U+I)."""
  users, items_g, ratings, p = _on(device, users, items_g, ratings, p0)
  users, items_g = _ids(users), _ids(items_g)
  p = p.to(torch.float32)

  def receivers(dst):
    recv = torch.zeros((n, 1), dtype=torch.bool, device=p.device)
    recv[dst] = True
    return recv

  def half_step(p, src_v, dst_v, recv):
    ps = p[src_v]
    err = ratings - (ps * p[dst_v]).sum(dim=-1)
    upd = torch.zeros_like(p).index_add_(0, dst_v, err[:, None] * ps)
    return torch.where(recv, p + gamma * (upd - lam * p), p)

  to_users, to_items = receivers(users), receivers(items_g)
  for _ in range(num_iters):
    p = half_step(p, items_g, users, to_users)   # users gather from items
    p = half_step(p, users, items_g, to_items)   # items gather from users
  return p
