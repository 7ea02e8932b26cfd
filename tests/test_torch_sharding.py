"""The port's partition specs against the reference's, with no allocation:
``ParamDef`` shapes, dtypes and specs of every config at ``tp`` 1 and 16,
``fsdp_defs``, the optimizer-state specs, ``batch_specs`` and
``cache_pspecs`` (both layouts, a batch the data axes divide and B = 1)
over every config × shape, ``SHAPES`` / ``shape_supported``, and each
leaf's largest local shard on the 16×16 and 2×16×16 meshes against
``NamedSharding.shard_shape`` (DTensor on a fake process group of 512
ranks, rank 0: the first chunk is the largest)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.transformer import build_model as j_build_model  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch._tree import tree_flatten_with_path  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402

ARCHS = JC.ARCHITECTURES
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _jkey(path) -> str:
  return "/".join(str(getattr(p, "key", getattr(p, "name",
                                                  getattr(p, "idx", p))))
                  for p in path)


def _jflat(tree, is_leaf=None):
  flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
  return {_jkey(p): leaf for p, leaf in flat}


def _tflat(tree):
  return dict(tree_flatten_with_path(tree))


def _spec(p):
  return None if p is None else tuple(p)


def _jdefs(arch, tp):
  return j_build_model(JC.get_config(arch), tp=tp).defs()


def _tdefs(arch, tp):
  return build_model(TC.get_config(arch), tp=tp).defs()


@pytest.mark.parametrize("tp", [1, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_pspecs_match_reference(arch, tp):
  jd, td = _jdefs(arch, tp), _tdefs(arch, tp)
  want = {k: (tuple(d.shape), np.dtype(d.dtype).name, _spec(d.pspec))
          for k, d in _jflat(jd, jcommon.is_param_def).items()}
  shapes = _tflat(tcommon.param_shapes(td))
  specs = _tflat(tcommon.param_pspecs(td))
  got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""),
             _spec(specs[k])) for k, t in shapes.items()}
  assert got == want
  assert all(t.device.type == "meta" for t in shapes.values())
  assert tcommon.num_params(td) == jcommon.num_params(jd)


def test_heads_pad_for_the_tensor_axis():
  """At tp 16: 56 -> 64 heads (deepseek-coder-33b), 40 -> 48 (qwen2.5-32b);
  no vocabulary changes (256 is a multiple of 16)."""
  for arch, heads in (("deepseek_coder_33b", 64), ("qwen2_5_32b", 48)):
    cfg = TC.get_config(arch)
    assert cfg.padded_heads(16) == heads
    assert _tdefs(arch, 16)["layers"]["attn"]["wq"].shape[-1] == \
        heads * cfg.resolved_head_dim
  for arch in ARCHS:
    cfg = TC.get_config(arch)
    assert cfg.padded_vocab(16) == cfg.padded_vocab(1)


def test_shapes_table_matches_reference():
  assert TC.SHAPES == JC.SHAPES
  for arch in ARCHS:
    for shape in JC.SHAPES:
      assert TC.shape_supported(TC.get_config(arch), shape) == \
          JC.shape_supported(JC.get_config(arch), shape)


def _dp_sizes(mp):
  return (("pod", "data"), 32) if mp else (("data",), 16)


@pytest.mark.parametrize("mp", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_launch_specs_match_reference(arch, mp):
  """fsdp_defs, opt_state_pspecs/shapes, batch_specs and cache_pspecs (both
  layouts; each shape's batch, and B = 1) for every shape."""
  dp_axes, dp_size = _dp_sizes(mp)
  jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
  jd, td = _jdefs(arch, 16), _tdefs(arch, 16)
  jf, tf = JS.fsdp_defs(jd, dp_axes, dp_size), TS.fsdp_defs(td, dp_axes,
                                                            dp_size)
  assert {k: _spec(v) for k, v in _tflat(tcommon.param_pspecs(tf)).items()} \
      == {k: _spec(d.pspec)
          for k, d in _jflat(jf, jcommon.is_param_def).items()}
  jo = _jflat(JS.opt_state_pspecs(jf),
              is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
  to = _tflat(TS.opt_state_pspecs(tf))
  assert {k: _spec(v) for k, v in to.items()} == \
      {k: _spec(v) for k, v in jo.items()}
  js_ = _jflat(JS.opt_state_shapes(jf))
  ts_ = _tflat(TS.opt_state_shapes(tf))
  assert {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
          for k, t in ts_.items()} == \
      {k: (tuple(s.shape), np.dtype(s.dtype).name) for k, s in js_.items()}
  for shape, shp in JC.SHAPES.items():
    for batch in (shp["global_batch"], 1):
      for labels in (False, True):
        jsh, jsp = JS.batch_specs(jcfg, batch, shp["seq_len"], dp_axes,
                                  dp_size, with_labels=labels)
        tsh, tsp = TS.batch_specs(tcfg, batch, shp["seq_len"], dp_axes,
                                  dp_size, with_labels=labels)
        assert {k: _spec(v) for k, v in tsp.items()} == \
            {k: _spec(v) for k, v in jsp.items()}
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in tsh.items()} == \
            {k: (tuple(v.shape), np.dtype(v.dtype).name)
             for k, v in jsh.items()}
      for layout in ("head", "seq"):
        want = JS.cache_pspecs(jcfg, batch, dp_axes, dp_size, 16, layout)
        got = TS.cache_pspecs(tcfg, batch, dp_axes, dp_size, 16, layout)
        assert {k: _spec(v) for k, v in _tflat(got).items()} == \
            {k: _spec(v) for k, v in _jflat(
                want, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec)).items()}


def test_init_cache_abstract_is_meta_and_matches_reference():
  for arch in ARCHS:
    jm = j_build_model(JC.get_config(arch), tp=16)
    tm = build_model(TC.get_config(arch), tp=16)
    want = {k: (tuple(s.shape), np.dtype(s.dtype).name)
            for k, s in _jflat(jm.init_cache(4, 64, abstract=True)).items()}
    got = _tflat(tm.init_cache(4, 64, abstract=True))
    assert all(t.device.type == "meta" for t in got.values())
    assert {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in got.items()} == want


@pytest.fixture(scope="module")
def fake_group():
  """A fake process group of 512 ranks (this process is rank 0), destroyed
  at the module's end."""
  import torch.distributed as dist
  from repro_torch.launch.mesh import start_fake_group
  start_fake_group(512)
  yield
  dist.destroy_process_group()


def _largest_shards(defs, mesh):
  """{leaf: local shape} of rank 0's shard of each leaf (DTensor's
  ``torch.chunk`` split gives rank 0 the largest)."""
  from torch.distributed.tensor._utils import \
      compute_local_shape_and_global_offset
  sh = _tflat(tcommon.param_shardings(defs, mesh))
  return {k: tuple(compute_local_shape_and_global_offset(
      d.shape, s.mesh, s.placements)[0])
      for (k, d), s in zip(_tflat(defs).items(), sh.values())}


@pytest.mark.parametrize("mp", [False, True], ids=["16x16", "2x16x16"])
def test_largest_local_shard_matches_named_sharding(fake_group, mp):
  """Every leaf of every config (fsdp_defs applied, as the train cells
  place them): rank 0's DTensor shard equals the reference's
  ``NamedSharding.shard_shape``.  JAX refuses a shard_shape that does not
  divide; there the port's shard is the reference's padded one, ceil(dim /
  shards) (ROADMAP Queue 3)."""
  import torch.distributed as dist
  from torch.distributed.device_mesh import DeviceMesh
  shape, names = MESHES[mp]
  n = int(np.prod(shape))
  mesh = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                    mesh_dim_names=names)
  assert dist.get_world_size() >= n
  amesh = AbstractMesh(shape, names)
  dp_axes, dp_size = _dp_sizes(mp)
  uneven = 0
  for arch in ARCHS:
    jd = JS.fsdp_defs(_jdefs(arch, 16), dp_axes, dp_size)
    td = TS.fsdp_defs(_tdefs(arch, 16), dp_axes, dp_size)
    got = _largest_shards(td, mesh)
    for k, d in _jflat(jd, jcommon.is_param_def).items():
      try:
        want = NamedSharding(amesh, d.pspec).shard_shape(d.shape)
      except ValueError:
        uneven += 1
        want = tuple(-(-dim // _shards(e, amesh)) for dim, e in zip(
            d.shape, tuple(d.pspec) + (None,) * len(d.shape)))
      assert got[k] == tuple(want), (arch, k)
  assert uneven == 0


def _shards(entry, amesh) -> int:
  if entry is None:
    return 1
  axes = entry if isinstance(entry, tuple) else (entry,)
  return int(np.prod([amesh.shape[a] for a in axes]))


def test_placements_follow_the_spec():
  """An axis named at tensor dim i is Shard(i) on that mesh dimension; a
  tuple entry shards the one dim over both, major first; the rest
  Replicate."""
  from torch.distributed.tensor import Replicate, Shard

  class _Mesh:
    mesh_dim_names = ("pod", "data", "model")

  P = tcommon.P
  assert tcommon.placements(P(("pod", "data"), None, "model"), _Mesh) == \
      (Shard(0), Shard(0), Shard(2))
  assert tcommon.placements(P(None, "model"), _Mesh) == \
      (Replicate(), Replicate(), Shard(1))
  assert tcommon.placements(P(), _Mesh) == (Replicate(),) * 3
  with pytest.raises(ValueError, match="order"):
    tcommon.placements(P(("data", "pod")), _Mesh)
  assert tuple(P(None, ("pod", "data"))) == \
      tuple(jax.sharding.PartitionSpec(None, ("pod", "data")))
