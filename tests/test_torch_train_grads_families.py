"""The port's loss and gradients against ``jax.value_and_grad`` of the
reference's for the moe, hybrid and encdec families: each config's smoke
size, and Mixtral's with routing groups of 16 tokens with and without
capacity drops.  ``tests/test_torch_train_grads.py`` holds the other
families and the helpers, the tolerances and their reasons (a split that
keeps each file under a minute).
"""

import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from test_torch_train_grads import check_loss_and_grads  # noqa: E402

# Mixtral's smoke config in routing groups of 16 tokens (4 groups of the 2 x
# 16 batch, top-2 of 4 experts): capacity int(0.5 · 16 · 2 / 4) = 4 a group
# drops edges; at 8.0 (capacity 64, above the 32 edges of a group) nothing
# can drop.
MOE_CASES = {"drops": 0.5, "no_drops": 8.0}


@pytest.mark.parametrize("arch", [a for a in JC.ARCHITECTURES
                                  if JC.get_config(a).family in
                                  ("moe", "hybrid", "encdec")])
def test_loss_and_grads_match_jax(arch):
  check_loss_and_grads(arch)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_grads_with_and_without_drops_match_jax(case, monkeypatch):
  """The dropped edges' spare slot is cut off from the graph, so their
  tokens get no gradient through the experts, as in the reference."""
  route, kept = tmoe._route_group_sort, []

  def recording_route(*args):
    xe, aux = route(*args)
    kept.append(bool(aux[4].all()))
    return xe, aux
  monkeypatch.setattr(tmoe, "_route_group_sort", recording_route)
  check_loss_and_grads("mixtral_8x7b", moe_group_size=16,
                       capacity_factor=MOE_CASES[case])
  # Each layer's routing, in the forward and its recomputation: every edge
  # kept, or (the drop case) some edge dropped.
  assert kept and all(kept) == (case == "no_drops")
