"""Model registry: config name -> ModelConfig, plus builder re-export."""

from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model, build_model  # noqa: F401


def get_config(name: str) -> ModelConfig:
  from repro_torch import configs as cfgs
  return cfgs.get_config(name)


def list_architectures():
  from repro_torch import configs as cfgs
  return cfgs.ARCHITECTURES
