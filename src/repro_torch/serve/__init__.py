"""Serving substrate: prefill + batched decode."""

from repro_torch.serve.engine import make_decode_step, make_prefill, generate  # noqa: F401
