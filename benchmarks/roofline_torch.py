"""§Roofline on the port: three-term roofline per (arch × shape × mesh) from
the port's dry-run JSON.

The counterpart of ``benchmarks/roofline.py``, over the records that
``python -m repro_torch.launch.dryrun --out DIR`` writes (the reference's
fields: ``flops``, ``bytes_accessed``, ``collectives``, ``devices``,
``multi_pod``), on the H100's data-sheet rates (``benchmarks.common_torch``):

  compute   = FLOPs / 989 TF bf16                     [per-rank counts:
  memory    = bytes / 3.35 TB/s                         the records are one
  collective= link_bytes / 450 GB/s per card            rank's]

The dry-run records are PER-RANK (``analysis.CostMode`` on one rank of a
fake process group), so terms use the single-card denominators.  Collective
seconds use ring-algorithm effective bytes: all-gather/reduce-scatter move
(g-1)/g × bytes, all-reduce 2(g-1)/g, all-to-all (g-1)/g — divided over one
NVLink direction (450 GB/s, half the data sheet's 900 GB/s over both
directions; unmeasured).

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) computed analytically from
the config; the useful-compute ratio MODEL/counted flags remat and padding
waste.

Usage:
  PYTHONPATH=src python -m benchmarks.roofline_torch [--dir experiments/dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import Dict, Optional

from benchmarks.common_torch import (H100_BF16_OPS_PER_S, H100_BYTES_PER_S,
                                     H100_NVLINK_BYTES_PER_S)

PEAK_FLOPS = H100_BF16_OPS_PER_S   # bf16 per card
HBM_BW = H100_BYTES_PER_S          # per card
LINK_BW = H100_NVLINK_BYTES_PER_S  # per NVLink direction (unmeasured)


def ring_factor(kind: str, g: int) -> float:
  if g <= 1:
    return 0.0
  if kind == "all-reduce":
    return 2.0 * (g - 1) / g
  return (g - 1) / g  # all-gather / reduce-scatter / all-to-all / permute


def collective_seconds(collectives: Dict) -> float:
  total = 0.0
  for rec in collectives.values():
    g = rec.get("group_size", 0) or 0
    total += rec["bytes"] * ring_factor(rec["kind"], int(g)) / LINK_BW
  return total


# ---------------------------------------------------------------------------
# MODEL_FLOPS (analytic 6·N·D)
# ---------------------------------------------------------------------------


def model_flops(arch: str, shape: str, batch: Optional[int] = None,
                seq: Optional[int] = None) -> Optional[float]:
  """6·N(active)·D global; decode counts D = global_batch tokens.
  ``batch`` / ``seq`` are a record's global sizes where its cell overrides
  the shape's (the port's dry run takes such cells; the reference's
  records are always at the shape's sizes)."""
  from repro_torch import configs as C
  cfg = C.get_config(arch)
  shp = C.SHAPES[shape]
  batch = shp["global_batch"] if batch is None else batch
  seq = shp["seq_len"] if seq is None else seq
  n_active = active_params(cfg)
  if shp["kind"] == "train":
    tokens = seq * batch
    return 6.0 * n_active * tokens
  if shp["kind"] == "prefill":
    tokens = seq * batch
    return 2.0 * n_active * tokens
  # decode: one token per sequence
  return 2.0 * n_active * batch


def active_params(cfg) -> float:
  """Per-token active parameter count (MoE counts top-k + shared only)."""
  d = cfg.d_model
  n = 0.0
  vpad = cfg.padded_vocab(16)
  n += vpad * d                      # embed
  if not cfg.tie_embeddings:
    n += d * vpad
  L = cfg.num_layers

  def attn_params():
    if cfg.use_mla:
      qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
      hp = cfg.padded_heads(16)
      return (d * cfg.q_lora_rank + cfg.q_lora_rank * hp * qk
              + d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
              + cfg.kv_lora_rank * hp * (cfg.qk_nope_head_dim
                                         + cfg.v_head_dim)
              + hp * cfg.v_head_dim * d)
    hd = cfg.resolved_head_dim
    hp = cfg.padded_heads(16)
    return d * hp * hd * 2 + d * cfg.num_kv_heads * hd * 2

  if cfg.family in ("dense", "vlm"):
    n += L * (attn_params() + 3 * d * cfg.d_ff)
  elif cfg.family == "moe":
    ff = (cfg.top_k + cfg.num_shared_experts) * 3 * d * cfg.moe_d_ff
    n += L * (attn_params() + ff + d * cfg.num_experts)
  elif cfg.family == "ssm":
    di = cfg.ssm_expand * d
    dtr = max(d // 16, 1)
    n += L * (2 * d * di + di * (dtr + 2 * cfg.ssm_state) + dtr * di
              + di * d)
  elif cfg.family == "hybrid":
    di = cfg.ssm_expand * d
    nh = di // cfg.ssm_head_dim
    per_ssm = (2 * d * di + d * 2 * cfg.ssm_state + d * nh + di * d)
    n += L * per_ssm
    napps = L // cfg.hybrid_attn_every
    n += napps * (attn_params() + 3 * d * cfg.d_ff)  # shared weights reused
  elif cfg.family == "encdec":
    n += cfg.encoder_layers * (attn_params() + 3 * d * cfg.d_ff)
    n += L * (2 * attn_params() + 3 * d * cfg.d_ff)
  return n


# ---------------------------------------------------------------------------


def analyze_record(rec: Dict) -> Dict:
  t_comp = rec["flops"] / PEAK_FLOPS
  t_mem = rec["bytes_accessed"] / HBM_BW
  t_coll = collective_seconds(rec["collectives"])
  dominant = max(("compute", t_comp), ("memory", t_mem),
                 ("collective", t_coll), key=lambda kv: kv[1])[0]
  mf = model_flops(rec["arch"], rec["shape"], rec.get("batch"),
                   rec.get("seq"))
  chips = rec["devices"]
  useful = (mf / chips) / rec["flops"] if mf and rec["flops"] > 0 else None
  t_bound = max(t_comp, t_mem, t_coll)
  # Roofline fraction: useful model flops per chip over peak, relative to
  # the bound step time — "how close the bound step is to pure-compute".
  frac = ((mf / chips) / PEAK_FLOPS) / t_bound if mf and t_bound > 0 else None
  return dict(t_compute=t_comp, t_memory=t_mem, t_collective=t_coll,
              dominant=dominant, model_flops=mf,
              useful_ratio=useful, roofline_frac=frac)


def main(argv=None) -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--dir", default="experiments/dryrun")
  ap.add_argument("--md", default=None, help="write markdown table here")
  args = ap.parse_args(argv)
  rows = []
  for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
    with open(path) as f:
      rec = json.load(f)
    if rec.get("multi_pod"):
      continue  # roofline table is single-pod per spec
    a = analyze_record(rec)
    rows.append((rec, a))
  hdr = (f"{'arch':22s} {'shape':12s} {'comp_ms':>9s} {'mem_ms':>9s} "
         f"{'coll_ms':>9s} {'bound':>10s} {'useful':>7s} {'roofline':>8s}")
  lines = [hdr, "-" * len(hdr)]
  for rec, a in rows:
    lines.append(
        f"{rec['arch']:22s} {rec['shape']:12s} "
        f"{a['t_compute']*1e3:9.3f} {a['t_memory']*1e3:9.3f} "
        f"{a['t_collective']*1e3:9.3f} {a['dominant']:>10s} "
        f"{(a['useful_ratio'] or 0):7.3f} {(a['roofline_frac'] or 0):8.3f}")
  out = "\n".join(lines)
  print(out)
  if args.md:
    with open(args.md, "w") as f:
      f.write("```\n" + out + "\n```\n")
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
