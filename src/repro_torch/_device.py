"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"`` and raise when no card is present:
a CPU run happens only when the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
  dev = torch.device("cuda" if device is None else device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "CUDA is not available; pass device='cpu' to run on the host")
  return dev
