"""Synthetic token pipeline (data substrate).

The port of :mod:`repro.train.data`.  Each global step's batch is derived
from (seed, step) by the reference's numpy draws, copied as they are, so
both packages give the same tokens bit for bit; the batch comes back as
tensors on the requested device.  Deterministic and seekable: after a
restart any host regenerates its batches from the step counter alone.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, *,
                    step: int = 0, seed: int = 0,
                    device: DeviceLike = "cuda") -> Dict[str, Tensor]:
  """One batch with the model-family-appropriate keys: ``tokens`` and
  ``labels`` [B,S] int32 (vlm: ``tokens`` [B, S - F] behind ``vision_embeds``
  [B,F,d] float32, whose F positions take label -1; encdec: ``enc_frames``
  [B, encoder_seq, d] float32).

  A Zipf-ish unigram stream with a deterministic (seed, step) -> batch map.
  """
  dev = resolve_device(device)
  rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
  v = cfg.vocab_size
  # Zipf-ish ranks so the CE loss has realistic structure.
  ranks = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
  toks = np.minimum(ranks - 1, v - 1).astype(np.int32)
  out: Dict[str, np.ndarray] = {}
  if cfg.family == "vlm":
    fs = cfg.frontend_seq
    text = toks[:, :seq - fs + 1]
    out["tokens"] = text[:, :-1]
    out["vision_embeds"] = (
        rng.standard_normal((batch, fs, cfg.d_model), np.float32) * 0.02)
    out["labels"] = np.concatenate(
        [np.full((batch, fs), -1, np.int32), text[:, 1:]], axis=1)
  elif cfg.family == "encdec":
    out["tokens"] = toks[:, :seq]
    out["labels"] = toks[:, 1:seq + 1]
    out["enc_frames"] = (
        rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model),
                            np.float32) * 0.02)
  else:
    out["tokens"] = toks[:, :seq]
    out["labels"] = toks[:, 1:seq + 1]
  return {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for k, a in out.items()}


@dataclasses.dataclass
class SyntheticTokenPipeline:
  """Iterator facade with seek() for restart-resume."""

  cfg: ModelConfig
  batch: int
  seq: int
  seed: int = 0
  step: int = 0
  device: DeviceLike = "cuda"

  def seek(self, step: int) -> None:
    self.step = step

  def __iter__(self) -> Iterator[Dict[str, Tensor]]:
    return self

  def __next__(self) -> Dict[str, Tensor]:
    b = synthetic_batch(self.cfg, self.batch, self.seq, step=self.step,
                        seed=self.seed, device=self.device)
    self.step += 1
    return b
