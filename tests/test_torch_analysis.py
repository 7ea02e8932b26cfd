"""The port's cost counting (``repro_torch.analysis``) — the counterparts of
``tests/test_hlo_analysis.py`` where they mean something in eager torch:
layers counted one by one in place of the trip multiplier, collective
bytes and counts per group size, an in-place cache write counted by the
region it writes.  And on the unsharded prefill of smoke granite_3_2b and
mixtral_8x7b, the port's product FLOPs against the reference's dot FLOPs
as ``repro.analysis.hlo_cost`` reads them from the jitted HLO (within 2%).
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import CostMode, analyze, collective_bytes  # noqa: E402


def _layers(x, w, n):
  for _ in range(n):
    x = x @ w
  return x


def test_dot_flops_counted_per_layer():
  """2 · |out|(8·16) · contracting(16) = 4096 a product, 10 layers."""
  x, w = torch.randn(8, 16), torch.randn(16, 16)
  res = analyze(_layers, x, w, 10)
  assert res["product_flops"] == 4096 * 10
  assert res["flops"] == 4096 * 10
  assert analyze(_layers, x, w, 5)["flops"] * 2 == res["flops"]


def test_elementwise_and_transcendentals():
  x = torch.randn(8, 16)
  res = analyze(lambda t: torch.exp(t) * 2.0 + t, x)
  assert res["transcendentals"] == 128
  assert res["flops"] == 2 * 128
  # exp: 512 B in, 512 out; mul, add: likewise (add reads two tensors).
  assert res["bytes"] == 512 * 2 + 512 * 2 + 512 * 3


def test_views_and_allocations_move_no_bytes():
  x = torch.randn(8, 16)
  res = analyze(lambda t: (t.reshape(16, 8).T, torch.empty(64)), x)
  assert res["bytes"] == 0 and res["flops"] == 0


def test_index_copy_counts_region_not_buffer():
  """An in-place cache write per layer: 3 × the written region (read and
  write of the destination region, read of the source) plus the index, not
  the whole [10, 8, 16] buffer in and out."""
  buf = torch.zeros(10, 8, 16)
  src = torch.ones(1, 8, 16)
  idx = torch.tensor([3])

  def write(b):
    for _ in range(10):
      b.index_copy_(0, idx, src)
    return b

  res = analyze(write, buf)
  assert res["bytes"] == 10 * (3 * 512 + 8)
  assert res["bytes"] < 10 * (10 * 8 * 16 * 4) * 2


def test_product_flops_under_fake_tensors():
  from torch._subclasses.fake_tensor import FakeTensorMode
  with FakeTensorMode():
    x, w = torch.empty(8, 16), torch.empty(16, 16)
    assert analyze(_layers, x, w, 10)["flops"] == 4096 * 10


@pytest.fixture
def fake16():
  import torch.distributed as dist
  from repro_torch.launch.mesh import start_fake_group
  start_fake_group(16)
  yield
  dist.destroy_process_group()


def test_collective_bytes_per_layer(fake16):
  """A product and an all-reduce over a group of 16 per layer, 10 layers:
  10 all-reduces of 8·16·4 B each."""
  import torch.distributed._functional_collectives as funcol
  from torch.distributed.device_mesh import init_device_mesh
  mesh = init_device_mesh("cpu", (16,), mesh_dim_names=("model",))
  x, w = torch.randn(8, 16), torch.randn(16, 16)

  def step(x):
    for _ in range(10):
      x = funcol.wait_tensor(funcol.all_reduce(x @ w, "sum", (mesh, 0)))
    return x

  res = analyze(step, x)
  (rec,) = [v for v in res["collectives"].values()
            if v["kind"] == "all-reduce"]
  assert rec["group_size"] == 16
  assert rec["count"] == 10
  assert rec["bytes"] == 8 * 16 * 4 * 10
  assert collective_bytes(res["collectives"]) == 8 * 16 * 4 * 10
  assert res["product_flops"] == 4096 * 10


def test_c10d_collectives_counted_with_their_group(fake16):
  """``torch.distributed``'s own collectives (the 2-D runner's), which
  dispatch c10d's in-place ops: an all-reduce over the world, one over a
  group of 4 and an all-gather over that group, each with its group's size
  and its output bytes."""
  import torch.distributed as dist
  group = dist.new_group([0, 1, 2, 3])
  x = torch.ones(8)

  def step(x):
    dist.all_reduce(x)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    parts = [torch.empty_like(x) for _ in range(4)]
    dist.all_gather(parts, x, group=group)
    return parts

  res = analyze(step, x)
  assert {k: (v["kind"], v["group_size"], v["count"], v["bytes"])
          for k, v in res["collectives"].items()} == {
      "all-reduce|16": ("all-reduce", 16, 1, 32),
      "all-reduce|4": ("all-reduce", 4, 1, 32),
      "all-gather|4": ("all-gather", 4, 1, 4 * 32)}


def test_dtensor_counts_the_rank_not_the_global_op(fake16):
  """On DTensors the mode counts the local shards' product and DTensor's
  collective, not DTensor's shape propagation at global shapes."""
  from torch._subclasses.fake_tensor import FakeTensorMode
  from torch.distributed.device_mesh import init_device_mesh
  from torch.distributed.tensor import Replicate, Shard, distribute_tensor
  mesh = init_device_mesh("cpu", (16,), mesh_dim_names=("model",))
  with FakeTensorMode():
    x = distribute_tensor(torch.empty(32, 256), mesh, [Replicate()],
                          src_data_rank=None)
    w1 = distribute_tensor(torch.empty(256, 512), mesh, [Shard(1)],
                           src_data_rank=None)
    w2 = distribute_tensor(torch.empty(512, 256), mesh, [Shard(0)],
                           src_data_rank=None)
    res = analyze(lambda: (x @ w1 @ w2).redistribute(mesh, [Replicate()]))
  assert res["product_flops"] == 2 * 32 * 32 * 256 * 2
  (rec,) = res["collectives"].values()
  assert (rec["kind"], rec["group_size"], rec["count"]) == \
      ("all-reduce", 16, 1)
  assert rec["bytes"] == 32 * 256 * 4


# ---------------------------------------------------------------------------
# Against the reference's HLO count
# ---------------------------------------------------------------------------


def _ref_dot_flops(hlo: str) -> float:
  """Σ dot FLOPs over the module, ``while`` bodies times their trips
  (``repro.analysis.hlo_cost``'s parse and rules, dots only)."""
  from repro.analysis.hlo_cost import HloCost, _dot_flops
  hc = HloCost(hlo)
  memo = {}

  def cost(name):
    if name in memo:
      return memo[name]
    total = 0.0
    for ins in hc.comps.get(name, []):
      if ins.op == "dot":
        total += _dot_flops(ins, hc.shapes[name])
      elif ins.op == "while":
        body = re.search(r"body=%?([\w.\-]+)", ins.line).group(1)
        cond = re.search(r"condition=%?([\w.\-]+)", ins.line).group(1)
        total += hc._trip_count(cond) * cost(body)
      else:
        total += sum(cost(c) for c in ins.callees)
    memo[name] = total
    return total

  return cost(hc.entry)


@pytest.mark.parametrize("arch", ["granite_3_2b", "mixtral_8x7b"])
def test_prefill_product_flops_match_reference_hlo(arch):
  jax = pytest.importorskip("jax")
  import jax.numpy as jnp
  from repro import configs as JC
  from repro.models import common as jcommon
  from repro.models.transformer import build_model as j_build_model
  from repro_torch import configs as TC
  from repro_torch.models.common import params_from_numpy
  from repro_torch.models.transformer import build_model

  jcfg = JC.get_smoke_config(arch)
  jm = j_build_model(jcfg, tp=1)
  params = jcommon.init_params(jm.defs(), jax.random.PRNGKey(0))
  tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 32),
                                             dtype=np.int32)
  hlo = jax.jit(lambda p, t: jm.forward(p, {"tokens": t})[0]).lower(
      params, jnp.asarray(tokens)).compile().as_text()
  want = _ref_dot_flops(hlo)
  tm = build_model(TC.get_smoke_config(arch))
  tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
  with torch.no_grad():
    got = analyze(tm.forward, tparams,
                  {"tokens": torch.from_numpy(tokens).long()})
  assert want > 0
  assert abs(got["product_flops"] - want) <= 0.02 * want, \
      (got["product_flops"], want)


def test_cost_mode_is_a_context():
  with CostMode() as mode:
    torch.randn(4, 4) @ torch.randn(4, 4)
  assert mode.result()["product_flops"] == 2 * 4 * 4 * 4


def test_vocab_sharded_cross_entropy_moves_no_logits():
  """Cross entropy on logits sharded (B over "data", V over "model") on a
  fake 2×2 group: the collectives carry [B, S] fields and scalars, never
  the [B, S, V] logits (the reference's masked-sum formulation)."""
  import torch.distributed as dist
  from torch._subclasses.fake_tensor import FakeTensorMode
  from torch.distributed.device_mesh import init_device_mesh
  from torch.distributed.tensor import Replicate, Shard, distribute_tensor
  from repro_torch.launch.mesh import start_fake_group
  from repro_torch.train.steps import cross_entropy
  start_fake_group(4)
  try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    b, s, v = 8, 64, 4096
    with FakeTensorMode():
      logits = distribute_tensor(torch.empty(b, s, v), mesh,
                                 [Shard(0), Shard(2)], src_data_rank=None)
      labels = distribute_tensor(torch.zeros(b, s, dtype=torch.long), mesh,
                                 [Shard(0), Replicate()], src_data_rank=None)
      res = analyze(cross_entropy, logits, labels)
    local_logits = (b // 2) * s * (v // 2) * 4
    assert res["collectives"]
    for rec in res["collectives"].values():
      assert rec["bytes"] / rec["count"] <= (b // 2) * s * 4 < local_logits
  finally:
    dist.destroy_process_group()
