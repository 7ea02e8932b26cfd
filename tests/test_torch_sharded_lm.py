"""The sharded LM on a CPU mesh: four spawned gloo ranks on a 2×2 ("data",
"model") ``DeviceMesh``, ``tp=2``, ``dp_spec="data"``, at the smoke sizes of
one config of each family — granite_3_2b (dense), mixtral_8x7b (MoE, "tp"
experts), deepseek_v2_236b (MoE, "ep" experts, MLA), falcon_mamba_7b (SSM;
the fused scan's plain version under ``local_map``), zamba2_7b (hybrid)
and seamless_m4t_medium (encdec).  Weights are the reference's
(``jax.random``), carried across by ``params_from_numpy`` and placed by
``param_shardings``; the batch by ``batch_specs``, the decode cache by
``cache_pspecs`` (the "seq" layout).

Each rank runs the prefill, two decode steps and one train step (loss,
every gradient, and the AdamW update on them) sharded and unsharded on the
same weights.  Tolerances: sharded against unsharded rtol 1e-5 with atol
1e-5 · max|unsharded| (a sum split over ranks adds in another order, so a
value near 0 has no relative error to hold); the sharded prefill against
the reference's jitted prefill at the unsharded port's own tolerance
against it, rtol = atol = 2e-4 (``tests/test_torch_lm.py``: XLA's fusions
round otherwise).

Also: the "seq" layout with the cache split over its slots (kv heads that
do not divide ``tp``; the flash-decode of ``sharding``), B = 1 (slots over
both mesh axes), an FSDP train step (``fsdp_defs``), and the elastic
re-mesh of a checkpoint from 4×2 to 2×2 ranks.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ARCHS = ["granite_3_2b", "mixtral_8x7b", "deepseek_v2_236b",
         "falcon_mamba_7b", "zamba2_7b", "seamless_m4t_medium"]
B, S, T = 4, 16, 16
F32_REF = dict(rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# Ranks (module level: spawned ranks import this module, which imports no
# JAX at top level)
# ---------------------------------------------------------------------------


def _nest(flat):
  out = {}
  for key, arr in flat.items():
    node = out
    parts = key.split("/")
    for p in parts[:-1]:
      node = node.setdefault(p, {})
    node[parts[-1]] = torch.from_numpy(np.array(arr))
  return out


def _mesh():
  from torch.distributed.device_mesh import init_device_mesh
  return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def _batch(data, cfg, labels):
  b = {"tokens": torch.from_numpy(data["tokens"]).long()}
  if cfg.family == "encdec":
    b["enc_frames"] = torch.from_numpy(data["enc_frames"])
  if labels:
    b["labels"] = torch.from_numpy(data["labels"]).long()
  return b


def _place_batch(batch, mesh, cfg, dp=("data",), dp_size=2):
  from repro_torch.launch import specs as S_
  from repro_torch.models.common import distribute_params
  n = batch["tokens"].shape[0]
  _, specs = S_.batch_specs(cfg, n, batch["tokens"].shape[1], dp, dp_size,
                            with_labels="labels" in batch)
  return distribute_params(batch, S_.named(mesh, specs))


def _full(t):
  from torch.distributed.tensor import DTensor
  return t.full_tensor() if isinstance(t, DTensor) else t


def _err(got, want) -> float:
  """max |got - want| / (1e-5·max|want| + 1e-5·|want|): ≤ 1 passes rtol
  1e-5 with atol 1e-5·max|want|."""
  got, want = _full(got).detach().double(), want.detach().double()
  scale = 1e-5 * want.abs().max() + 1e-5 * want.abs()
  return float(((got - want).abs() / torch.clamp(scale, min=1e-30)).max())


def _decode(model, params, cache, tokens, n):
  outs = []
  for pos in range(n):
    logits, cache = model.decode_step(params, tokens[:, pos:pos + 1], cache,
                                      pos)
    outs.append(logits)
  return outs


def _case(mesh, arch, data, *, cfg_over=None, layout="seq", fsdp=False,
          batch=B, parts=("prefill", "decode", "train")):
  """One config's sharded-vs-unsharded errors (≤ 1 passes)."""
  from repro_torch import configs as TC
  from repro_torch._tree import tree_leaves
  from repro_torch.launch import specs as S_
  from repro_torch.models import common as cm
  from repro_torch.models.transformer import build_model
  from repro_torch.train.optimizer import adamw_init, adamw_update
  from repro_torch.train.steps import make_loss_fn, value_and_grad

  cfg = TC.get_smoke_config(arch).scaled(**(cfg_over or {}))
  plain, sharded = build_model(cfg), build_model(cfg, tp=2, dp_spec="data")
  params = _nest(data["params"])
  defs = sharded.defs()
  if fsdp:
    defs = S_.fsdp_defs(defs, ("data",), 2)
  place = cm.param_shardings(defs, mesh)
  sp = cm.distribute_params(params, place)
  out = {}
  data = {k: v[:batch] if k != "params" else v for k, v in data.items()}

  full_batch = _batch(data, cfg, False)
  torch.set_grad_enabled(False)  # serving: prefill and decode
  if "prefill" in parts:
    want, _ = plain.forward(params, full_batch)
    got, _ = sharded.forward(sp, _place_batch(full_batch, mesh, cfg))
    out["prefill"] = _err(got, want)
    out["logits"] = _full(got)
    if cfg.family == "ssm":
      fused = build_model(cfg.scaled(ssm_impl="fused"), tp=2, dp_spec="data")
      got, _ = fused.forward(sp, _place_batch(full_batch, mesh, cfg))
      out["prefill_fused"] = _err(got, want)

  if "decode" in parts:
    tokens = torch.from_numpy(data["tokens"]).long()
    cache = plain.init_cache(batch, T, device="cpu")
    specs = S_.cache_pspecs(cfg, batch, ("data",), 2, 2, layout)
    scache = cm.distribute_params(cache, S_.named(mesh, specs))
    dp_tok = "data" if batch % 2 == 0 else None
    stok = cm.named(mesh, cm.P(dp_tok, None)).place(tokens)
    want = _decode(plain, params, cache, tokens, 2)
    got = _decode(sharded, sp, scache, stok, 2)
    out["decode"] = max(_err(g, w) for g, w in zip(got, want))
    out["cache_split"] = any(
        any(p.is_shard(2) for p in t.placements)
        for t in tree_leaves(scache))

  torch.set_grad_enabled(True)
  if "train" not in parts:
    return out
  tb = _batch(data, cfg, True)
  stb = _place_batch(tb, mesh, cfg)
  (l1, _), g1 = value_and_grad(make_loss_fn(plain))(params, tb)
  (l2, _), g2 = value_and_grad(make_loss_fn(sharded))(sp, stb)
  out["loss"] = _err(l2, l1)
  out["grads"] = max(_err(a, b) for a, b in zip(tree_leaves(g2),
                                                tree_leaves(g1)))
  # The AdamW update (in place, on copies) on the unsharded gradients,
  # placed as their parameters: the global norm sums the DTensor leaves'
  # partial squares.  (AdamW's first step divides each gradient by its own
  # magnitude, so where a gradient is near 0 it would turn the gradients'
  # rounding differences into O(1) ones.)
  p0 = _nest(data["params"])
  p1 = cm.distribute_params(_nest(data["params"]), place)
  _, _, n0 = adamw_update(g1, adamw_init(p0), p0, lr=torch.tensor(1e-2))
  _, _, n1 = adamw_update(cm.distribute_params(g1, place), adamw_init(p1), p1,
                          lr=torch.tensor(1e-2))
  out["step"] = max(_err(a, b) for a, b in zip(tree_leaves(p1),
                                               tree_leaves(p0)))
  out["grad_norm"] = _err(n1, n0)
  return out


def rank_lm(grid, data_dir: str):
  """One rank: every case of the module, on the 2×2 mesh."""
  del grid
  torch.set_num_threads(1)  # four ranks share the host's cores
  mesh = _mesh()
  data = {a: _load(data_dir, a) for a in ARCHS}
  res = {a: _case(mesh, a, data[a]) for a in ARCHS}
  kv1 = _load(data_dir, "kv1")
  res["kv_split"] = _case(mesh, "granite_3_2b", kv1,
                          cfg_over=dict(num_kv_heads=1), parts=("decode",))
  res["batch_one"] = _case(mesh, "granite_3_2b", kv1, batch=1,
                           cfg_over=dict(num_kv_heads=1), parts=("decode",))
  res["fsdp"] = _case(mesh, "granite_3_2b", data["granite_3_2b"], fsdp=True,
                      parts=("train",))
  return res if torch.distributed.get_rank() == 0 else {}


def _load(data_dir, name):
  z = np.load(os.path.join(data_dir, f"{name}.npz"))
  params = {k[2:]: z[k] for k in z.files if k.startswith("p/")}
  out = {k: z[k] for k in z.files if not k.startswith("p/")}
  out["params"] = params
  return out


def rank_remesh(grid, ckpt_dir: str):
  """8 ranks: a [64, 32] leaf placed ("data", "model") on 4×2 is saved and
  restored onto the first four ranks as a 2×2 mesh, ("model", "data")."""
  del grid
  torch.set_num_threads(1)
  from torch.distributed.device_mesh import DeviceMesh
  from torch.distributed.tensor import Shard
  from repro_torch.models.common import P, named
  from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
  mesh_a = DeviceMesh("cpu", torch.arange(8).reshape(4, 2),
                      mesh_dim_names=("data", "model"))
  mesh_b = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
  w = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
  sh_b = named(mesh_b, P("model", "data"))
  save_checkpoint(ckpt_dir, 7, {"w": named(mesh_a, P("data", "model"))
                                .place(w)})
  restored = restore_checkpoint(ckpt_dir, 7, {"w": torch.zeros_like(w)},
                                shardings={"w": sh_b})["w"]
  if torch.distributed.get_rank() >= 4:
    return {}
  full = restored.full_tensor()
  coord = mesh_b.get_coordinate()
  want_local = w[coord[1] * 32:(coord[1] + 1) * 32,
                 coord[0] * 16:(coord[0] + 1) * 16]
  return {"ok": bool(torch.equal(full, w)),
          "local_ok": bool(torch.equal(restored.to_local(), want_local)),
          "placements": tuple(restored.placements) == (Shard(1), Shard(0))}


# ---------------------------------------------------------------------------
# The parent: the reference's weights and prefill, then the ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def results(tmp_path_factory):
  jax = pytest.importorskip("jax")
  import jax.numpy as jnp
  from repro import configs as JC
  from repro.models import common as jcommon
  from repro.models.transformer import build_model as j_build_model
  from repro_torch.core.distributed import launch

  d = tmp_path_factory.mktemp("sharded_lm")
  ref = {}
  cases = [(a, a, {}) for a in ARCHS] + [
      ("kv1", "granite_3_2b", dict(num_kv_heads=1))]
  for name, arch, over in cases:
    jcfg = JC.get_smoke_config(arch).scaled(**over)
    jm = j_build_model(jcfg, tp=2)
    params = jcommon.init_params(jm.defs(), jax.random.PRNGKey(3))
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    rng = np.random.default_rng(7)
    arrs = {"p/" + "/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in flat}
    arrs["tokens"] = rng.integers(0, jcfg.vocab_size, (B, S), dtype=np.int32)
    arrs["labels"] = rng.integers(0, jcfg.vocab_size, (B, S), dtype=np.int32)
    arrs["labels"][0, :3] = -1
    batch = {"tokens": jnp.asarray(arrs["tokens"])}
    if jcfg.family == "encdec":
      arrs["enc_frames"] = rng.standard_normal(
          (B, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
      batch["enc_frames"] = jnp.asarray(arrs["enc_frames"])
    np.savez(d / f"{name}.npz", **arrs)
    if name in ARCHS:
      ref[name] = np.asarray(jax.jit(lambda p, b: jm.forward(p, b)[0])(
          params, batch))
  res = launch(rank_lm, 2, 2, str(d))[0]
  remesh = launch(rank_remesh, 4, 2, str(d / "ckpt"))[:4]
  return res, ref, remesh


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_unsharded_and_reference(results, arch):
  res, ref, _ = results
  assert res[arch]["prefill"] <= 1
  np.testing.assert_allclose(res[arch]["logits"].numpy(), ref[arch],
                             **F32_REF)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_unsharded(results, arch):
  assert results[0][arch]["decode"] <= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_unsharded(results, arch):
  """Loss, every gradient and the AdamW update."""
  r = results[0][arch]
  assert r["loss"] <= 1 and r["grads"] <= 1
  assert r["step"] <= 1 and r["grad_norm"] <= 1


def test_fused_scan_under_local_map(results):
  """``ssm_impl="fused"``: the scan runs per (batch × channel) shard."""
  assert results[0]["falcon_mamba_7b"]["prefill_fused"] <= 1


@pytest.mark.parametrize("case", ["kv_split", "batch_one"])
def test_slot_split_cache_flash_decode(results, case):
  """kv heads that do not divide tp: the "seq" layout splits the cache
  over its slots (B = 1: over both mesh axes), and decode attention
  combines the shards' softmax partials."""
  r = results[0][case]
  assert r["cache_split"]
  assert r["decode"] <= 1


def test_fsdp_train_step(results):
  r = results[0]["fsdp"]
  assert r["loss"] <= 1 and r["grads"] <= 1
  assert r["step"] <= 1 and r["grad_norm"] <= 1


def test_elastic_checkpoint_remesh(results):
  """A checkpoint written under mesh A (4×2, ("data", "model")) restores bit
  for bit onto mesh B (2×2, ("model", "data")), placed as asked: tensor
  dim 0 over "model" (mesh dim 1), dim 1 over "data" (mesh dim 0)."""
  for r in results[2]:
    assert r == {"ok": True, "local_ok": True, "placements": True}
