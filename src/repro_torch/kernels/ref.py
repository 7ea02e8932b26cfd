"""Plain PyTorch versions of the kernels (port of :mod:`repro.kernels.ref`).

The CPU tests run these, and ``chip_smoke.py`` holds each CUDA kernel
against its plain version on the card.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.core.semiring import _identity_for

_AXIS_RED = {"add": lambda x: x.sum(dim=1, dtype=x.dtype),
             "min": lambda x: x.amin(dim=1),
             "max": lambda x: x.amax(dim=1)}


def ell_spmv_ref(cols: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor,
                 msg: torch.Tensor, active: torch.Tensor, dprop: torch.Tensor,
                 *, process: Callable, reduce_kind: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain version of the ELL SpMV kernel.

  msg ``[n_src, K]``, dprop ``[n_pad, Kd]`` pre-permuted;
  ``process(m [..., K], e [...], d [..., Kd])``.  Returns
  ``(y [n_pad, K_out], recv int8[n_pad])``.
  """
  n_pad, w = cols.shape
  m = msg[cols]                                    # [n_pad, W, K]
  valid = mask.bool() & active.bool()[cols]
  dp = dprop[:, None, :].expand(n_pad, w, dprop.shape[1])
  r = process(m, vals, dp)
  r = torch.where(valid[..., None], r, _identity_for(reduce_kind, r.dtype))
  y = _AXIS_RED[reduce_kind](r)
  recv = valid.any(dim=1).to(torch.int8)
  return y, recv
