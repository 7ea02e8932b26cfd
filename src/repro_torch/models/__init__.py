"""LM model substrate: the dense (GQA or MLA), MoE and Mamba-1 (``"ssm"``)
families so far."""

from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.model_zoo import build_model  # noqa: F401
