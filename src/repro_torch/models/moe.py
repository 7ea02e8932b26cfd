"""Mixture-of-Experts — token→expert dispatch as a generalized SpMV (port of
:mod:`repro.models.moe`).

**This is where the paper's technique lands in the LM substrate.**  Top-k
routing builds a sparse bipartite graph between tokens and experts;
dispatch and combine are generalized SpMV on that graph:

    dispatch:  X_e = Aᵀ ⊗ X      (gather rows of X along edges, grouped
                                   by destination expert)
    combine:   Y   = A  ⊗ Y_e    (PROCESS = scale-by-gate, REDUCE = +)

The implementation is the *index* encoding of that SpMV — the edge list
(token, expert, gate) sorted by destination expert, exactly the dst-sorted
``CooGraph`` layout of :mod:`repro_torch.core.graph`; combine is the same
scatter-add segment reduction as ``spmv_coo``'s "add" fast path.  A one-hot
einsum encoding (the dense-mask form, GShard-style) is kept as
``moe_impl="onehot"`` for small shapes and for the GraphMat-equivalence
test (``tests/test_torch_moe.py``); the sort path is the production one: it
adds no matmul FLOPs, while the one-hot dispatch einsums cost O(T·E·Cg·d).

Tokens are routed in fixed-size **groups** (≤ ``group_size`` tokens) with a
per-group expert capacity.  Every function here takes all groups at once,
as tensors with a leading group axis ``[G, Tg, ...]`` (the reference maps
one group with ``vmap``).  On one card there is no mesh, so the
reference's sharding constraints and the expert-parallel layouts go.

Tie-breaking follows the reference: top-k puts the lower expert first on
equal probabilities (a stable descending sort, not ``torch.topk``), and the
edges are sorted by expert with a stable sort, so the capacity cut drops
the same (token, expert) edges.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.common import ParamDef, out_proj_einsum
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def moe_defs(cfg: ModelConfig) -> Dict[str, object]:
  d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
  defs = {
      "router": ParamDef((d, e), scale=0.02),
      "w_gate": ParamDef((e, d, ff)),
      "w_up": ParamDef((e, d, ff)),
      "w_down": ParamDef((e, ff, d)),
  }
  if cfg.num_shared_experts:
    sff = cfg.moe_d_ff * cfg.num_shared_experts
    defs["shared"] = {
        "w_gate": ParamDef((d, sff)),
        "w_up": ParamDef((d, sff)),
        "w_down": ParamDef((sff, d)),
    }
  return defs


def _group_capacity(cfg: ModelConfig, tg: int) -> int:
  cap = int(cfg.capacity_factor * tg * cfg.top_k / cfg.num_experts)
  return max(cap, cfg.top_k)


def _top_k(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
  """``lax.top_k`` over the last axis: the lower index first on ties."""
  vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
  return vals[..., :k], idx[..., :k]


def _gates(logits: Tensor, top_k: int) -> Tuple[Tensor, Tensor]:
  """(gate values renormalized over the top k, expert ids), each [..., k]."""
  probs = torch.softmax(logits.float(), dim=-1)
  gate_vals, gate_idx = _top_k(probs, top_k)
  return gate_vals / gate_vals.sum(dim=-1, keepdim=True), gate_idx


def _route_group_sort(logits: Tensor, x: Tensor, top_k: int,
                      num_experts: int, capacity: int):
  """logits [G,Tg,E], x [G,Tg,d].

  Returns (xe [G,E,Cg,d], aux = (e_sorted, slot_pos, tok_sorted,
  gate_sorted, keep), each [G, Tg·k]) — per group the dst-sorted
  token→expert edge list (CooGraph layout).  A dropped edge has
  ``slot_pos == capacity``."""
  g, tg = logits.shape[:2]
  d = x.shape[-1]
  gate_vals, gate_idx = _gates(logits, top_k)                  # [G,Tg,k]
  e_flat = gate_idx.reshape(g, tg * top_k)
  g_flat = gate_vals.reshape(g, tg * top_k)
  order = torch.argsort(e_flat, dim=-1, stable=True)  # edges by dst expert
  e_sorted = torch.gather(e_flat, 1, order)
  tok_sorted = order // top_k
  gate_sorted = torch.gather(g_flat, 1, order)
  first = torch.searchsorted(e_sorted, e_sorted)
  pos = torch.arange(tg * top_k, device=x.device) - first
  keep = pos < capacity
  slot_pos = torch.where(keep, pos, capacity)      # overflow -> dropped slot
  # One spare slot per expert takes the dropped edges and is cut off: the
  # reference's out-of-bounds ``mode="drop"`` write.
  rows = ((torch.arange(g, device=x.device)[:, None] * num_experts
           + e_sorted) * (capacity + 1) + slot_pos).reshape(-1)
  src = torch.gather(x, 1, tok_sorted[..., None].expand(-1, -1, d))
  xe = x.new_zeros((g * num_experts * (capacity + 1), d))
  xe.index_copy_(0, rows, src.reshape(-1, d))
  xe = xe.reshape(g, num_experts, capacity + 1, d)[:, :, :capacity]
  return xe, (e_sorted, slot_pos, tok_sorted, gate_sorted, keep)


def _combine_group_sort(ye: Tensor, aux, tg: int) -> Tensor:
  """ye [G,E,Cg,d] -> y [G,Tg,d]: the segment scatter-add of ``spmv_coo``,
  in ``ye``'s dtype."""
  e_sorted, slot_pos, tok_sorted, gate_sorted, keep = aux
  g, num_experts, cap, d = ye.shape
  grp = torch.arange(g, device=ye.device)[:, None]
  rows = (grp * num_experts + e_sorted) * cap + torch.clamp(slot_pos,
                                                            max=cap - 1)
  y_slot = ye.reshape(-1, d).index_select(0, rows.reshape(-1))
  y_slot = torch.where(keep.reshape(-1, 1), y_slot, 0)
  w = torch.where(keep, gate_sorted, 0.0).to(ye.dtype).reshape(-1, 1)
  y = ye.new_zeros((g * tg, d))
  y.index_add_(0, (grp * tg + tok_sorted).reshape(-1), y_slot * w)
  return y.reshape(g, tg, d)


def _route_group_onehot(logits: Tensor, x: Tensor, top_k: int,
                        num_experts: int, capacity: int):
  """Dense-mask (one-hot) encoding; small shapes / equivalence tests only.
  logits [G,Tg,E], x [G,Tg,d] -> (xe [G,E,Cg,d], comb [G,Tg,E,Cg])."""
  g, tg = logits.shape[:2]
  gate_vals, gate_idx = _gates(logits, top_k)
  onehot = torch.nn.functional.one_hot(gate_idx, num_experts).float()
  flat = onehot.reshape(g, tg * top_k, num_experts)
  pos = torch.cumsum(flat, dim=1) - flat
  pos = (pos.reshape(g, tg, top_k, num_experts) * onehot).sum(-1)  # [G,T,k]
  keep = pos < capacity
  # An overflowing edge (slot == capacity) one-hots to all zeros.
  slot_oh = torch.nn.functional.one_hot(
      torch.where(keep, pos, capacity).long(), capacity + 1
  )[..., :capacity].float() * keep[..., None]
  disp = torch.einsum("gtke,gtkc->gtec", onehot, slot_oh)
  comb = torch.einsum("gtke,gtkc,gtk->gtec", onehot, slot_oh, gate_vals)
  xe = torch.einsum("gtec,gtd->gecd", disp.to(x.dtype), x)
  return xe, comb


def _experts(params, xe: Tensor, cfg: ModelConfig) -> Tensor:
  """The routed experts' SwiGLU on their capacity slots: [G,E,Cg,d] ->
  [G,E,Cg,d], the gate in float32 as in the reference."""
  cd = cfg.compute_dtype
  h_g = torch.einsum("gecd,edf->gecf", xe, params["w_gate"].to(cd))
  h_u = torch.einsum("gecd,edf->gecf", xe, params["w_up"].to(cd))
  h = torch.nn.functional.silu(h_g.float()).to(cd) * h_u
  return out_proj_einsum("gecf,efd->gecd", h, params["w_down"], cfg)


def moe_forward(params, x: Tensor, cfg: ModelConfig, *,
                group_size: int = 512, moe_impl: str = "sort") -> Tensor:
  """x [B,S,d] -> [B,S,d].  See the module docstring."""
  cd = cfg.compute_dtype
  b, s, d = x.shape
  tg = min(group_size, s)
  g = b * s // tg
  xt = x.reshape(g, tg, d)
  logits = torch.einsum("gtd,de->gte", xt, params["router"].to(cd))
  capacity = _group_capacity(cfg, tg)

  if moe_impl == "sort":
    xe, aux = _route_group_sort(logits, xt, cfg.top_k, cfg.num_experts,
                                capacity)
    yt = _combine_group_sort(_experts(params, xe, cfg), aux, tg)
  else:
    xe, comb = _route_group_onehot(logits, xt, cfg.top_k, cfg.num_experts,
                                   capacity)
    yt = torch.einsum("gtec,gecd->gtd", comb.to(cd),
                      _experts(params, xe, cfg))

  y = yt.reshape(b, s, d)
  if cfg.num_shared_experts:
    sp = params["shared"]
    sg = torch.matmul(x, sp["w_gate"].to(cd))
    su = torch.matmul(x, sp["w_up"].to(cd))
    sh = torch.nn.functional.silu(sg.float()).to(cd) * su
    y = y + out_proj_einsum("bsf,fd->bsd", sh, sp["w_down"], cfg)
  return y


def moe_aux_loss(router_logits: Tensor, top_k: int,
                 num_experts: int) -> Tensor:
  """Switch-style load-balancing auxiliary loss (mean over tokens)."""
  probs = torch.softmax(router_logits.float(), dim=-1)
  probs2 = probs.reshape(-1, num_experts)
  _, idx = _top_k(probs2, top_k)
  hard = torch.nn.functional.one_hot(idx, num_experts).float().sum(dim=1)
  frac_tokens = hard.mean(dim=0)
  frac_probs = probs2.mean(dim=0)
  return num_experts * torch.sum(frac_tokens * frac_probs)
