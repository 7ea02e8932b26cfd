"""Collaborative filtering by gradient descent, as GraphMat states it (the
paper's equations 3-6) for one latent matrix ``P`` over users then items.

A sweep is two phases.  Phase U: each user ``u`` that rated something sums
``(r_ui - p_u . p_i) p_i`` over its ratings and takes ``p_u + gamma (sum -
lam p_u)``; items keep theirs.  Phase V: the same for items, over the users'
new vectors.  ``gamma`` is ``1 / (the largest degree x the mean rating)``,
worked out here from the ratings.  Sums run in float64; ``dtype=bfloat16``
keeps ``P`` in bfloat16 and sums in float32 (the control).
"""

from __future__ import annotations

import torch

BLOCK_EDGES = 1 << 24


def step_size(user: torch.Tensor, item: torch.Tensor, rating: torch.Tensor,
              users: int, items: int) -> float:
  max_deg = max(int(torch.bincount(user, minlength=users).max()),
                int(torch.bincount(item, minlength=items).max()))
  return 1.0 / (max_deg * float(rating.to(torch.float64).mean()))


def _phase(p: torch.Tensor, to: torch.Tensor, frm: torch.Tensor,
           rating: torch.Tensor, gamma: float, lam: float, acc
           ) -> torch.Tensor:
  total = torch.zeros(p.shape, dtype=acc, device=p.device)
  for lo in range(0, to.numel(), BLOCK_EDGES):
    t, f = to[lo:lo + BLOCK_EDGES], frm[lo:lo + BLOCK_EDGES]
    m, d = p[f].to(acc), p[t].to(acc)
    err = rating[lo:lo + BLOCK_EDGES, None].to(acc) - (m * d).sum(
        -1, keepdim=True)
    total.index_add_(0, t, err * m)
  got = torch.bincount(to, minlength=p.shape[0]) > 0
  old = p.to(acc)
  new = (old + gamma * (total - lam * old)).to(p.dtype)
  return torch.where(got[:, None], new, p)


def cf(user: torch.Tensor, item: torch.Tensor, rating: torch.Tensor,
       users: int, p0: torch.Tensor, sweeps: int, gamma: float, lam: float,
       dtype=torch.float64) -> torch.Tensor:
  """``P`` after ``sweeps`` sweeps from ``p0`` (``[users + items, K]``,
  users first), as float32."""
  acc = torch.float64 if dtype == torch.float64 else torch.float32
  vid = item + users
  p = p0.to(dtype)
  for _ in range(sweeps):
    p = _phase(p, user, vid, rating, gamma, lam, acc)
    p = _phase(p, vid, user, rating, gamma, lam, acc)
  return p.to(torch.float32)
