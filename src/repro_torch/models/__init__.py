"""LM model substrate: the Mamba-1 (``"ssm"``) family so far."""

from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.model_zoo import build_model  # noqa: F401
