"""Plain PyTorch version of the selective-scan kernel: a loop over time."""

from __future__ import annotations

import torch


def selective_scan_ref(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       bmat: torch.Tensor, cmat: torch.Tensor) -> torch.Tensor:
  """Sequential reference.  Shapes as in
  :func:`repro_torch.kernels.selective_scan.selective_scan`."""
  b, s, c = u.shape
  n = bmat.shape[-1]
  u, dt, a, bmat, cmat = (x.float() for x in (u, dt, a, bmat, cmat))
  h = torch.zeros((b, c, n), dtype=torch.float32, device=u.device)
  ys = torch.empty((b, s, c), dtype=torch.float32, device=u.device)
  for t in range(s):
    a_bar = torch.exp(dt[:, t, :, None] * a[None])             # [B,C,N]
    bu = (dt[:, t] * u[:, t])[..., None] * bmat[:, t, None, :]
    h = a_bar * h + bu
    ys[:, t] = torch.sum(h * cmat[:, t, None, :], dim=-1)        # [B,C]
  return ys
