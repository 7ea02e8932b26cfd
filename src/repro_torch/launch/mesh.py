"""Production mesh construction (functions, not module-level constants: an
import never touches the process group).

The reference's meshes are ``jax.make_mesh`` over its devices; the port's
are ``init_device_mesh`` over the current process group.  A dry run needs
no card: it starts a fake process group of the mesh's world size
(:func:`start_fake_group`), whose collectives move nothing, and traces
under ``FakeTensorMode``.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
  """16×16 (one 256-chip pod) or 2×16×16 (two pods, 512 chips) over the
  current process group, which must have that many ranks.

  Axes: "pod" — pod replicas (pure data parallel), "data" — in-pod
  data/FSDP axis, "model" — tensor/expert axis.
  """
  shape = (2, 16, 16) if multi_pod else (16, 16)
  axes = ("pod", "data", "model") if multi_pod else ("data", "model")
  return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def data_axes(multi_pod: bool):
  return ("pod", "data") if multi_pod else ("data",)


def start_fake_group(world_size: int, rank: int = 0) -> None:
  """Make the default process group a fake one of ``world_size`` ranks, as
  rank ``rank`` sees it (a group already there of another size is
  destroyed first).  Its collectives return at once and move nothing: a
  dry run traces one rank's step on it with no allocation and no peers.

  The fake backend lives in ``torch.testing._internal``, a private module;
  this raises if the installed torch lacks it."""
  try:
    from torch.testing._internal.distributed.fake_pg import FakeStore
  except ImportError as e:
    raise RuntimeError(
        "the dry run needs torch.testing._internal.distributed.fake_pg "
        "(the fake process group), which this torch does not have") from e
  if dist.is_initialized():
    if (dist.get_backend() == "fake" and dist.get_world_size() == world_size
        and dist.get_rank() == rank):
      return
    dist.destroy_process_group()
  dist.init_process_group("fake", store=FakeStore(), rank=rank,
                          world_size=world_size)
