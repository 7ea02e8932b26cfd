"""State-space layers: Mamba-1 (selective scan) and Mamba-2 (SSD).

The port of :mod:`repro.models.ssm`.  Mamba-1: under ``ssm_impl="assoc"``
the recurrence runs as a chunked scan of plain tensor ops (log-depth within
a chunk, a loop across chunks), materializing the discretized [B,S,C,N]
operands; under ``ssm_impl="fused"`` it runs as the hand-written CUDA
selective-scan kernel
(:func:`repro_torch.kernels.selective_scan.selective_scan`), which keeps the
state out of device memory.  There is one device and no mesh, so the
reference's ``shard_map`` around the kernel becomes a direct call.

Mamba-2 (the hybrid family's layer) is SSD in its matmul form, as in the
reference: within a chunk an attention-like masked product, across chunks
a loop carrying the [B,H,N,P] state.  It is einsums and elementwise ops
only; the reference has no kernel for it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models.common import ParamDef, out_proj_einsum, rms_norm
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def mamba1_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
  d_inner = cfg.ssm_expand * cfg.d_model
  dt_rank = max(cfg.d_model // 16, 1)
  return d_inner, dt_rank, cfg.ssm_state


def mamba1_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
  d = cfg.d_model
  d_inner, dt_rank, n = mamba1_dims(cfg)
  return {
      "in_proj_u": ParamDef((d, d_inner)),
      "in_proj_z": ParamDef((d, d_inner)),
      "conv_w": ParamDef((cfg.ssm_conv, d_inner), scale=0.2),
      "conv_b": ParamDef((d_inner,), init="zeros"),
      "x_proj": ParamDef((d_inner, dt_rank + 2 * n)),
      "dt_proj": ParamDef((dt_rank, d_inner)),
      "dt_bias": ParamDef((d_inner,), init="zeros"),
      "a_log": ParamDef((d_inner, n), init="ones"),
      "d_skip": ParamDef((d_inner,), init="ones"),
      "out_proj": ParamDef((d_inner, d)),
  }


def _causal_conv(u: Tensor, w: Tensor, b: Tensor,
                 state: Optional[Tensor] = None) -> Tensor:
  """Depthwise causal conv1d as a sum of shifted products (not ``conv1d``,
  which goes through cuDNN).  u [B,S,C], w [K,C].  ``state``: [B,K-1,C]
  prefix for decode continuation."""
  k = w.shape[0]
  if state is None:
    up = F.pad(u, (0, 0, k - 1, 0))
  else:
    up = torch.cat([state.to(u.dtype), u], dim=1)
  out = sum(up[:, i:i + u.shape[1], :] * w[i] for i in range(k))
  return out + b


def _scan_chunked(a: Tensor, bx: Tensor, h0: Tensor, chunk: int
                  ) -> Tuple[Tensor, Tensor]:
  """h_t = a_t * h_{t-1} + bx_t along axis 1.

  a, bx: [B, S, ...]; h0 [B, ...].  Returns (h over time [B,S,...], h_last).
  Within a chunk: a log-depth (Hillis-Steele) inclusive scan of the pairs
  (a, bx) under (a_l, b_l)∘(a_r, b_r) = (a_l a_r, a_r b_l + b_r); across
  chunks: a loop carrying h.  The combine order differs from the
  reference's ``associative_scan``, so the two agree to rounding.
  """
  s = a.shape[1]
  chunk = min(chunk, s)
  if s % chunk:
    raise ValueError(f"seq {s} not divisible by chunk {chunk}")
  hs = []
  h = h0
  for c0 in range(0, s, chunk):
    aa, bb = a[:, c0:c0 + chunk], bx[:, c0:c0 + chunk]
    d = 1
    while d < chunk:
      aa, bb = (torch.cat([aa[:, :d], aa[:, d:] * aa[:, :-d]], dim=1),
                torch.cat([bb[:, :d], aa[:, d:] * bb[:, :-d] + bb[:, d:]],
                          dim=1))
      d *= 2
    h_t = aa * h[:, None] + bb
    h = h_t[:, -1]
    hs.append(h_t)
  return torch.cat(hs, dim=1), h


def _discretize(dt: Tensor, a: Tensor, bmat: Tensor, u: Tensor
                ) -> Tuple[Tensor, Tensor]:
  """(a_bar, b_bar·u), [B,S,C,N] f32, from dt [B,S,C], a [C,N], bmat
  [B,S,N], u [B,S,C]."""
  a_bar = torch.exp(dt[..., None] * a)
  bu = dt[..., None] * bmat[:, :, None, :].float() * u[..., None].float()
  return a_bar, bu


def _project(params, u: Tensor, cfg: ModelConfig
             ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
  """The convolution's output -> (u, dt, bmat, cmat): u [B,S,C] in the
  compute dtype, dt [B,S,C] f32, bmat/cmat [B,S,N] in the compute dtype."""
  cd = cfg.compute_dtype
  _, dt_rank, n = mamba1_dims(cfg)
  u = F.silu(u.float()).to(cd)
  dbc = torch.matmul(u, params["x_proj"].to(cd))
  dt, bmat, cmat = torch.split(dbc, [dt_rank, n, n], dim=-1)
  dt = torch.matmul(dt, params["dt_proj"].to(cd))
  # F.softplus returns x above its threshold (20) where the reference's
  # logaddexp(x, 0) adds log1p(exp(-x)) < 2.1e-9: equal in float32.
  dt = F.softplus(dt.float() + params["dt_bias"].float())          # [B,S,C]
  return u, dt, bmat, cmat


def _gate_out(params, y: Tensor, u: Tensor, z: Tensor, cfg: ModelConfig,
              spec: str) -> Tensor:
  y = y + params["d_skip"].float() * u.float()
  y = (y * F.silu(z.float())).to(cfg.compute_dtype)
  return out_proj_einsum(spec, y, params["out_proj"], cfg)


def mamba1_forward(params, x: Tensor, cfg: ModelConfig,
                   h0: Optional[Tensor] = None) -> Tensor:
  """x [B,S,d] -> [B,S,d] (prefill path)."""
  cd = cfg.compute_dtype
  b = x.shape[0]
  d_inner, _, n = mamba1_dims(cfg)
  u = torch.matmul(x, params["in_proj_u"].to(cd))
  z = torch.matmul(x, params["in_proj_z"].to(cd))
  u = _causal_conv(u, params["conv_w"].to(cd), params["conv_b"].to(cd))
  u, dt, bmat, cmat = _project(params, u, cfg)
  a = -torch.exp(params["a_log"].float())                            # [C,N]
  if cfg.ssm_impl == "fused":
    # The CUDA kernel: h stays in registers, the [B,S,C,N] discretization
    # never reaches device memory.
    y = selective_scan(u.float(), dt, a, bmat.float().contiguous(),
                       cmat.float().contiguous(), seq_chunk=cfg.ssm_chunk)
  else:
    # Discretize: a_bar, b_bar·u [B,S,C,N]; ssm_scan_dtype trades
    # scan-operand precision for device-memory bytes.
    sdt = getattr(torch, cfg.ssm_scan_dtype)
    a_bar, bu = _discretize(dt, a, bmat, u)
    h0 = (torch.zeros((b, d_inner, n), dtype=sdt, device=x.device)
          if h0 is None else h0)
    hs, _ = _scan_chunked(a_bar.to(sdt), bu.to(sdt), h0, cfg.ssm_chunk)
    y = torch.einsum("bscn,bsn->bsc", hs.float(), cmat.float())
  return _gate_out(params, y, u, z, cfg, "bsc,cd->bsd")


def mamba1_decode(params, x: Tensor, state: Dict[str, Tensor],
                  cfg: ModelConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
  """One token.  x [B,1,d]; state {"conv": [B,K-1,C], "h": [B,C,N]}."""
  cd = cfg.compute_dtype
  u = torch.matmul(x, params["in_proj_u"].to(cd))
  z = torch.matmul(x, params["in_proj_z"].to(cd))
  u_conv = _causal_conv(u, params["conv_w"].to(cd), params["conv_b"].to(cd),
                        state=state["conv"])
  new_conv = torch.cat([state["conv"][:, 1:], u.to(state["conv"].dtype)],
                       dim=1)
  u, dt, bmat, cmat = _project(params, u_conv, cfg)
  a = -torch.exp(params["a_log"].float())
  a_bar, bu = _discretize(dt, a, bmat, u)                  # [B,1,C,N]
  h = a_bar[:, 0] * state["h"] + bu[:, 0]
  y = torch.einsum("bcn,bn->bc", h, cmat[:, 0].float())
  out = _gate_out(params, y, u[:, 0], z[:, 0], cfg, "bc,cd->bd")[:, None]
  return out, {"conv": new_conv, "h": h}


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------


def mamba2_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
  d_inner = cfg.ssm_expand * cfg.d_model
  nheads = d_inner // cfg.ssm_head_dim
  return d_inner, nheads, cfg.ssm_head_dim, cfg.ssm_state


def mamba2_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
  d = cfg.d_model
  d_inner, nheads, _, n = mamba2_dims(cfg)
  # Projections split (z | x | BC | dt), as in the reference; one B/C group.
  return {
      "in_proj_z": ParamDef((d, d_inner)),
      "in_proj_x": ParamDef((d, d_inner)),
      "in_proj_bc": ParamDef((d, 2 * n)),
      "in_proj_dt": ParamDef((d, nheads)),
      "conv_w": ParamDef((cfg.ssm_conv, d_inner + 2 * n), scale=0.2),
      "conv_b": ParamDef((d_inner + 2 * n,), init="zeros"),
      "a_log": ParamDef((nheads,), init="ones"),
      "dt_bias": ParamDef((nheads,), init="zeros"),
      "d_skip": ParamDef((nheads,), init="ones"),
      "norm_g": ParamDef((d_inner,), init="ones"),
      "out_proj": ParamDef((d_inner, d)),
  }


def _ssd_chunk_scan(x: Tensor, dt: Tensor, a: Tensor, bmat: Tensor,
                    cmat: Tensor, chunk: int) -> Tensor:
  """SSD in matmul form.  x [B,S,H,P]; dt [B,S,H]; a [H] (negative);
  bmat/cmat [B,S,N]; all float32.  Returns y [B,S,H,P] (float32).

  h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_tᵀ ;  y_t = C_t · h_t
  """
  b, s, h, p = x.shape
  n = bmat.shape[-1]
  chunk = min(chunk, s)
  if s % chunk:
    raise ValueError(f"seq {s} % chunk {chunk} != 0")
  nc = s // chunk
  xr = x.reshape(b, nc, chunk, h, p)
  dtr = dt.reshape(b, nc, chunk, h)
  br = bmat.reshape(b, nc, chunk, n)
  cr = cmat.reshape(b, nc, chunk, n)
  cum = torch.cumsum(dtr * a, dim=2)                   # [B,nc,C,H] log-decay

  # Intra-chunk ("attention") term: L[i,j] = exp(cum_i - cum_j) for j <= i.
  # Above the diagonal cum_i - cum_j > 0 and exp overflows to inf at long
  # chunks; the select drops it (a multiply by the mask would give NaN).
  li = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,nc,C,C,H]
  causal = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
  lmat = torch.where(causal[:, :, None], torch.exp(li), 0.0)
  del li
  cb = torch.einsum("bkin,bkjn->bkij", cr, br)         # [B,nc,C,C]
  w = cb[..., None] * lmat * dtr[:, :, None, :, :]     # [B,nc,C,C,H]
  del lmat
  y = torch.einsum("bkijh,bkjhp->bkihp", w, xr)
  del w

  # Chunk-final states: S_k = Σ_j exp(cum_last - cum_j)·dt_j·B_j x_jᵀ.
  decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)    # [B,nc,C,H]
  sx = xr * (dtr * decay_to_end)[..., None]            # [B,nc,C,H,P]
  s_chunk = torch.einsum("bkjn,bkjhp->bkhnp", br, sx)  # [B,nc,H,N,P]

  # Inter-chunk recurrence over k: h' = exp(Σ la over the chunk) h + S_k;
  # chunk k reads the state before it.
  a_chunk = torch.exp(cum[:, :, -1, :])                # [B,nc,H]
  hk = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
  hprevs = []
  for k in range(nc):
    hprevs.append(hk)
    hk = a_chunk[:, k, :, None, None] * hk + s_chunk[:, k]
  hprevs = torch.stack(hprevs, dim=1)                  # [B,nc,H,N,P]

  # Inter-chunk contribution: y_i += C_i · (decay_from_start_i ∘ h_prev).
  y_inter = (torch.einsum("bkin,bkhnp->bkihp", cr, hprevs)
             * torch.exp(cum)[..., None])
  return (y + y_inter).reshape(b, s, h, p)


def _mamba2_in(params, x: Tensor, cfg: ModelConfig,
               conv_state: Optional[Tensor] = None):
  """The projections and the causal conv over x [B,S,d] (``conv_state``
  [B,K-1,C+2N] continues a decode).  Returns (z [B,S,d_inner] and xbc
  [B,S,C+2N] before the conv, in the compute dtype; xh [B,S,H,P], dt
  [B,S,H], bmat and cmat [B,S,N], in float32)."""
  cd = cfg.compute_dtype
  b, s, _ = x.shape
  d_inner, nheads, hd, n = mamba2_dims(cfg)
  z = torch.matmul(x, params["in_proj_z"].to(cd))
  xbc = torch.cat([torch.matmul(x, params["in_proj_x"].to(cd)),
                   torch.matmul(x, params["in_proj_bc"].to(cd))], dim=-1)
  dt = torch.matmul(x, params["in_proj_dt"].to(cd))
  xbc_c = _causal_conv(xbc, params["conv_w"].to(cd), params["conv_b"].to(cd),
                       state=conv_state)
  xbc_c = F.silu(xbc_c.float()).to(cd)
  xs, bmat, cmat = torch.split(xbc_c, [d_inner, n, n], dim=-1)
  # F.softplus equals the reference's in float32 (see _project).
  dt = F.softplus(dt.float() + params["dt_bias"].float())          # [B,S,H]
  xh = xs.reshape(b, s, nheads, hd).float()
  return z, xbc, xh, dt, bmat.float(), cmat.float()


def _mamba2_out(params, y: Tensor, xh: Tensor, z: Tensor, cfg: ModelConfig
                ) -> Tensor:
  """The skip, the SiLU(z) gate, the gated RMSNorm and ``out_proj``: y and
  xh [B,S,H,P] float32, z [B,S,d_inner] -> [B,S,d]."""
  b, s = y.shape[:2]
  y = y + params["d_skip"].float()[:, None] * xh
  y = (y.reshape(b, s, -1) * F.silu(z.float())).to(cfg.compute_dtype)
  y = rms_norm(y, params["norm_g"], cfg.norm_eps)
  return out_proj_einsum("bsc,cd->bsd", y, params["out_proj"], cfg)


def mamba2_forward(params, x: Tensor, cfg: ModelConfig) -> Tensor:
  """x [B,S,d] -> [B,S,d] (prefill path); S a multiple of the chunk."""
  z, _, xh, dt, bmat, cmat = _mamba2_in(params, x, cfg)
  a = -torch.exp(params["a_log"].float())                            # [H]
  y = _ssd_chunk_scan(xh, dt, a, bmat, cmat, cfg.ssm_chunk)
  return _mamba2_out(params, y, xh, z, cfg)


def mamba2_decode(params, x: Tensor, state: Dict[str, Tensor],
                  cfg: ModelConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
  """One token.  x [B,1,d]; state {"conv": [B,K-1,C+2N] in the compute
  dtype, "h": [B,H,N,P] float32}.  Returns (out [B,1,d], a new state); the
  state passed in is left as it was."""
  z, xbc, xh, dt, bmat, cmat = _mamba2_in(params, x, cfg,
                                          conv_state=state["conv"])
  new_conv = torch.cat([state["conv"][:, 1:], xbc.to(state["conv"].dtype)],
                       dim=1)
  a = -torch.exp(params["a_log"].float())
  a_bar = torch.exp(dt[:, 0] * a)                                  # [B,H]
  bu = dt[:, 0, :, None, None] * torch.einsum("bn,bhp->bhnp", bmat[:, 0],
                                              xh[:, 0])
  h = a_bar[..., None, None] * state["h"] + bu
  y = torch.einsum("bn,bhnp->bhp", cmat[:, 0], h)
  return _mamba2_out(params, y[:, None], xh, z, cfg), {"conv": new_conv,
                                                       "h": h}
