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
one group with ``vmap``).

Sharding, as in the reference: "ep" shards the expert axis over "model"
(DeepSeek-V2: 160/16 = 10 experts a column); "tp" shards each expert's
hidden over "model" (Mixtral: 8 wide experts, 14336/16 = 896 each).  With
DTensor parameters and a ``dp_spec``, the reference's sharding constraints
become redistributions (:func:`repro_torch.models.sharding.constrain`): the
dispatch all-to-all to the expert-sharded ``[G(data), E, Cg, d]`` layout and
the combine's back to token-sharded.  The routing and the combine touch one
group at a time, and DTensor has no rule for their sort and scatters, so
they run per shard of the group axis (``sharding.per_group``).

Tie-breaking follows the reference: top-k puts the lower expert first on
equal probabilities (a stable descending sort, not ``torch.topk``), and the
edges are sorted by expert with a stable sort, so the capacity cut drops
the same (token, expert) edges.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import sharding as shd
from repro_torch.models.common import P, ParamDef, out_proj_einsum
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def moe_defs(cfg: ModelConfig) -> Dict[str, object]:
  d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
  if cfg.moe_sharding == "ep":
    up_spec = P("model", None, None)
    down_spec = P("model", None, None)
  else:
    up_spec = P(None, None, "model")
    down_spec = P(None, "model", None)
  defs = {
      "router": ParamDef((d, e), P(None, None), scale=0.02),
      "w_gate": ParamDef((e, d, ff), up_spec),
      "w_up": ParamDef((e, d, ff), up_spec),
      "w_down": ParamDef((e, ff, d), down_spec),
  }
  if cfg.num_shared_experts:
    sff = cfg.moe_d_ff * cfg.num_shared_experts
    defs["shared"] = {
        "w_gate": ParamDef((d, sff), P(None, "model")),
        "w_up": ParamDef((d, sff), P(None, "model")),
        "w_down": ParamDef((sff, d), P("model", None)),
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


def _experts(params, xe: Tensor, cfg: ModelConfig,
             constrain_h=lambda h: h) -> Tensor:
  """The routed experts' SwiGLU on their capacity slots: [G,E,Cg,d] ->
  [G,E,Cg,d], the gate in float32 as in the reference; ``constrain_h``
  places the hidden [G,E,Cg,ff]."""
  cd = cfg.compute_dtype
  h_g = torch.einsum("gecd,edf->gecf", xe, params["w_gate"].to(cd))
  h_u = torch.einsum("gecd,edf->gecf", xe, params["w_up"].to(cd))
  h = constrain_h(torch.nn.functional.silu(h_g.float()).to(cd) * h_u)
  return out_proj_einsum("gecf,efd->gecd", h, params["w_down"], cfg)


def moe_forward(params, x: Tensor, cfg: ModelConfig, *,
                group_size: int = 512, dp_spec=None,
                moe_impl: str = "sort") -> Tensor:
  """x [B,S,d] -> [B,S,d].  See the module docstring.  ``dp_spec``: the
  data mesh axes the group axis is constrained to ("data", ("pod",
  "data")), or ``None`` for no constraint, as in the reference."""
  cd = cfg.compute_dtype
  b, s, d = x.shape
  tg = min(group_size, s)
  g = b * s // tg
  xt = x.reshape(g, tg, d)
  logits = torch.einsum("gtd,de->gte", xt, params["router"].to(cd))
  capacity = _group_capacity(cfg, tg)

  e_axis = "model" if cfg.moe_sharding == "ep" else None
  ff_axis = "model" if cfg.moe_sharding == "tp" else None

  def constrain(z, spec):
    return z if dp_spec is None else shd.constrain(z, spec)

  if moe_impl == "sort":
    xe, *aux = shd.per_group(
        lambda lg, xg: _flat(_route_group_sort(lg, xg, cfg.top_k,
                                               cfg.num_experts, capacity)),
        logits, xt, n_out=6)
    # The dispatch all-to-all: [G(data), E, Cg, d] -> expert-sharded.
    xe = constrain(xe, P(dp_spec, e_axis, None, None))
    ye = _experts(params, xe, cfg, lambda h: constrain(
        h, P(dp_spec, e_axis, None, ff_axis)))
    # The combine all-to-all: back to token-sharded for the local scatter.
    ye = constrain(ye, P(dp_spec, None, None, None))
    yt = shd.per_group(lambda y, *a: _combine_group_sort(y, a, tg), ye, *aux)
  else:
    xe, comb = shd.per_group(
        lambda lg, xg: _route_group_onehot(lg, xg, cfg.top_k,
                                           cfg.num_experts, capacity),
        logits, xt, n_out=2)
    xe = constrain(xe, P(dp_spec, e_axis, None, None))
    ye = constrain(_experts(params, xe, cfg), P(dp_spec, None, None, None))
    yt = torch.einsum("gtec,gecd->gtd", comb.to(cd), ye)

  y = yt.reshape(b, s, d)
  if cfg.num_shared_experts:
    sp = params["shared"]
    sg = torch.matmul(x, sp["w_gate"].to(cd))
    su = torch.matmul(x, sp["w_up"].to(cd))
    sh = torch.nn.functional.silu(sg.float()).to(cd) * su
    y = y + out_proj_einsum("bsf,fd->bsd", sh, sp["w_down"], cfg)
  return y


def _flat(routed):
  xe, aux = routed
  return (xe, *aux)


def _hard_top_k(probs: Tensor, top_k: int, num_experts: int) -> Tensor:
  """[N,E] probabilities -> [N,E] 0/1, one at each of the top k."""
  _, idx = _top_k(probs, top_k)
  return torch.nn.functional.one_hot(idx, num_experts).float().sum(dim=1)


def moe_aux_loss(router_logits: Tensor, top_k: int,
                 num_experts: int) -> Tensor:
  """Switch-style load-balancing auxiliary loss (mean over tokens).  The
  top-k picks run per token (``sharding.per_group`` on DTensors); the
  means over tokens are global."""
  probs = torch.softmax(router_logits.float(), dim=-1)
  probs2 = probs.reshape(-1, num_experts)
  hard = shd.per_group(lambda p: _hard_top_k(p, top_k, num_experts), probs2)
  frac_tokens = hard.mean(dim=0)
  frac_probs = probs2.mean(dim=0)
  return num_experts * torch.sum(frac_tokens * frac_probs)
