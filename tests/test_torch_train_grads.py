"""The port's loss and gradients against ``jax.value_and_grad`` of the
reference's.

* The training loss (``make_loss_fn``: cross entropy + the MoE aux loss)
  and every parameter's gradient, in float32, at the smoke size of each of
  the dense, vlm and ssm configs (each with ``remat="full"``, as
  published), from the same weights and ``synthetic_batch``.  The
  reference's function is jitted once a model.  The moe, hybrid and encdec
  configs are ``tests/test_torch_train_grads_families.py``'s (the split
  keeps each file under a minute).
* ``remat`` none, full and selective give the same gradients, and
  selective recomputes what full does except the weight products.
* The fused selective scan refuses autograd in both packages: the port
  raises ``RuntimeError`` on the CPU (and on the card), the reference's
  Pallas kernel cannot be differentiated.
* The SSD's overflow: ``_ssd_chunk_scan``'s forward is finite where its
  upper-triangle log-decays overflow, and its gradient is NaN in the same
  places in both packages (a fault of the reference the port keeps).
* bfloat16 compute: the embedding's gradient, summed over repeated tokens
  in float32 by the port and in bfloat16 by the reference.

Tolerances: the loss rtol 1e-5; each gradient leaf rtol 2e-4 and atol 2e-5
of the leaf's largest magnitude (the frameworks sum in other orders;
1e-6 to 3.5e-6 of the largest was seen).  bfloat16: rtol 3e-2 and atol 3e-2
of the leaf's largest magnitude (the frameworks round to bfloat16 at other
places).  Remat changes no arithmetic, so its gradients compare bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.kernels.selective_scan import selective_scan_pallas  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.transformer import build_model as j_build_model  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch._tree import tree_flatten_with_path, tree_map  # noqa: E402
from repro_torch.kernels import selective_scan as smod  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.train import adamw_init, make_eval_step  # noqa: E402
from repro_torch.train.data import synthetic_batch  # noqa: E402
from repro_torch.train.steps import (make_loss_fn, make_train_step,  # noqa: E402
                                     value_and_grad)

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_OF_MAX = 2e-4, 2e-5
BF16_RTOL, BF16_OF_MAX = 3e-2, 3e-2
B, S = 2, 16


def _params(tcfg, seed=0):
  """Weights drawn by the port's ``init_params`` on the CPU, and the same
  numbers as the reference's tree of arrays (the trees share their keys)."""
  tparams = init_params(build_model(tcfg).defs(),
                        torch.Generator().manual_seed(seed), device="cpu")
  return tparams, tree_map(lambda t: jnp.asarray(t.numpy()), tparams)


def _by_key(tree):
  return dict(tree_flatten_with_path(tree))


def _port_grads(model, params, batch):
  (total, parts), grads = value_and_grad(make_loss_fn(model))(params, batch)
  return total, parts, grads


def _ref_grads(jcfg, jparams, batch):
  jm = j_build_model(jcfg, tp=1)
  fn = jax.jit(jax.value_and_grad(jsteps.make_loss_fn(jm), has_aux=True))
  (loss, parts), grads = fn(jparams, batch)
  return loss, parts, grads


def _assert_grads_close(got, want, rtol, of_max):
  got_k, want_k = _by_key(got), _by_key(want)
  assert sorted(got_k) == sorted(want_k)
  for k, g in got_k.items():
    w = np.asarray(want_k[k], np.float32)
    assert np.isfinite(w).all(), k
    np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol,
                               atol=of_max * np.abs(w).max(), err_msg=k)


def _case(arch, **over):
  jcfg = JC.get_smoke_config(arch).scaled(**over)
  tcfg = TC.get_smoke_config(arch).scaled(**over)
  return jcfg, tcfg


def check_loss_and_grads(arch, **over):
  """The port's loss, MoE aux loss and gradients against the reference's,
  in float32 with the config's own remat (full); returns the port's
  config."""
  jcfg, tcfg = _case(arch, **over)
  assert tcfg.remat == "full" and tcfg.dtype == "float32"
  tparams, jparams = _params(tcfg)
  batch = synthetic_batch(tcfg, B, S, step=1, seed=0, device="cpu")
  loss, parts, grads = _port_grads(build_model(tcfg), tparams, batch)
  jloss, jparts, jgrads = _ref_grads(
      jcfg, jparams, jdata.synthetic_batch(jcfg, B, S, step=1, seed=0))
  np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
  np.testing.assert_allclose(float(parts["moe_aux"]), float(jparts["moe_aux"]),
                             rtol=LOSS_RTOL)
  _assert_grads_close(grads, jgrads, GRAD_RTOL, GRAD_OF_MAX)
  return tcfg


@pytest.mark.parametrize("arch", [a for a in JC.ARCHITECTURES
                                  if JC.get_config(a).family in
                                  ("dense", "vlm", "ssm")])
def test_loss_and_grads_match_jax(arch):
  check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ["granite_3_2b", "mixtral_8x7b", "zamba2_7b",
                                  "seamless_m4t_medium"])
def test_remat_modes_give_equal_grads(arch):
  """none, full and selective: the same loss and gradients, bit for bit;
  full remat recomputes each layer's forward in the backward pass."""
  tcfg = TC.get_smoke_config(arch)
  tparams, _ = _params(tcfg, seed=3)
  batch = synthetic_batch(tcfg, B, S, step=2, device="cpu")
  out = {}
  for remat in ("none", "full", "selective"):
    out[remat] = _port_grads(build_model(tcfg.scaled(remat=remat)), tparams,
                             batch)
  for remat in ("full", "selective"):
    assert torch.equal(out[remat][0], out["none"][0])
    for (k, a), (_, b) in zip(tree_flatten_with_path(out[remat][2]),
                              tree_flatten_with_path(out["none"][2])):
      assert torch.equal(a, b), (remat, k)


def _op_counts(model, params, batch):
  """aten.mm, batch-of-one aten.bmm, wider aten.bmm and aten.exp calls of a
  forward and backward."""
  from torch.utils._python_dispatch import TorchDispatchMode
  counts = {"mm": 0, "bmm1": 0, "bmm": 0, "exp": 0}

  class Count(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
      if func is torch.ops.aten.mm.default:
        counts["mm"] += 1
      elif func is torch.ops.aten.bmm.default:
        counts["bmm1" if args[0].shape[0] == 1 else "bmm"] += 1
      elif func is torch.ops.aten.exp.default:
        counts["exp"] += 1
      return func(*args, **(kwargs or {}))

  with Count():
    _port_grads(model, params, batch)
  return counts


def test_selective_remat_saves_the_weight_products():
  """Full remat runs each layer's weight products again in the backward
  pass; selective saves them (``aten.mm``, and the batch-of-one
  ``aten.bmm`` of a no-batch einsum), as JAX's
  ``dots_with_no_batch_dims_saveable`` does, and recomputes the rest (the
  attention's batched products, its exponentials) as full does."""
  tcfg = TC.get_smoke_config("granite_3_2b")
  tparams, _ = _params(tcfg)
  batch = synthetic_batch(tcfg, B, S, device="cpu")
  n = {r: _op_counts(build_model(tcfg.scaled(remat=r)), tparams, batch)
       for r in ("none", "full", "selective")}
  for op in ("mm", "bmm1"):
    assert n["selective"][op] == n["none"][op] < n["full"][op], (op, n)
  for op in ("bmm", "exp"):
    assert n["selective"][op] == n["full"][op] > n["none"][op], (op, n)


def test_remat_recomputes_only_under_grad():
  """Under grad, full remat runs a layer again in the backward pass; with
  grad off (serving) the layer runs as it is."""
  calls = []

  def layer(lp, h):
    calls.append(1)
    return h * h, 0.0
  x = torch.ones(3, requires_grad=True)
  y, _ = T._remat(layer, "full")({}, x)
  y.sum().backward()
  assert len(calls) == 2 and torch.equal(x.grad, torch.full((3,), 2.0))
  with torch.no_grad():
    assert T._remat(layer, "full") is layer
  with pytest.raises(ValueError, match="remat"):
    T._remat(layer, "everything")


def test_fused_scan_refuses_autograd_in_both_packages():
  """The port raises rather than return a y cut off from the graph; the
  reference's Pallas kernel cannot be differentiated either."""
  rng = np.random.default_rng(0)
  u, dt = rng.standard_normal((2, 1, 8, 4)).astype(np.float32)
  dt = np.abs(dt) * 0.1
  a = -np.ones((4, 2), np.float32)
  bm, cm = rng.standard_normal((2, 1, 8, 2)).astype(np.float32)
  with pytest.raises(AssertionError):
    jax.grad(lambda u: selective_scan_pallas(
        u, jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm),
        jnp.asarray(cm)).sum())(jnp.asarray(u))
  tu = torch.from_numpy(u).requires_grad_()
  rest = [torch.from_numpy(x) for x in (dt, a, bm, cm)]
  with pytest.raises(RuntimeError, match="no backward"):
    smod.selective_scan(tu, *rest)
  with torch.no_grad():
    y = smod.selective_scan(tu, *rest)
  assert y.shape == (1, 8, 4) and not y.requires_grad
  # Inputs that need no grad run as before, grad mode or not.
  assert torch.equal(smod.selective_scan(tu.detach(), *rest), y)


def test_fused_train_step_raises_and_eval_step_runs():
  """Falcon-Mamba's smoke config with ``ssm_impl="fused"``: a train step
  raises; the eval step (grad off) runs the scan and equals ``assoc``'s."""
  tcfg = TC.get_smoke_config("falcon_mamba_7b")
  fused = build_model(tcfg.scaled(ssm_impl="fused"))
  tparams, _ = _params(tcfg)
  batch = synthetic_batch(tcfg, B, S, device="cpu")
  with pytest.raises(RuntimeError, match="no backward"):
    make_train_step(fused)(tparams, adamw_init(tparams), batch)
  got = make_eval_step(fused)(tparams, batch)
  want = make_eval_step(build_model(tcfg))(tparams, batch)
  np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                             rtol=LOSS_RTOL)


def test_ssd_overflow_grad_is_nan_where_the_reference_is():
  """B, S, H, P, N = 1, 16, 2, 4, 3 at chunk 16, dt = 10, a = -1: above
  the diagonal the log-decays reach 150 and ``exp`` overflows.  The
  forward is finite in both packages (``where`` selects 0); the backward
  multiplies the selected-away zeros by inf, and the gradient with respect
  to dt is NaN in both, in the same places; where finite, equal."""
  rng = np.random.default_rng(0)
  x = rng.standard_normal((1, 16, 2, 4)).astype(np.float32)
  dt = np.full((1, 16, 2), 10.0, np.float32)
  a = -np.ones((2,), np.float32)
  bm = rng.standard_normal((1, 16, 3)).astype(np.float32)
  cm = rng.standard_normal((1, 16, 3)).astype(np.float32)

  @jax.jit
  def jscan(dt):
    return jssm._ssd_chunk_scan(jnp.asarray(x), dt, jnp.asarray(a),
                                jnp.asarray(bm), jnp.asarray(cm), 16)
  jy = jscan(jnp.asarray(dt))
  jg = np.asarray(jax.jit(jax.grad(lambda d: jscan(d).sum()))(
      jnp.asarray(dt)))
  tdt = torch.from_numpy(dt).requires_grad_()
  ty = tssm._ssd_chunk_scan(torch.from_numpy(x), tdt, torch.from_numpy(a),
                            torch.from_numpy(bm), torch.from_numpy(cm), 16)
  (tg,) = torch.autograd.grad(ty.sum(), tdt)
  assert np.isfinite(np.asarray(jy)).all() and torch.isfinite(ty).all()
  np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=2e-4,
                             atol=2e-4)
  tg = tg.numpy()
  assert np.isnan(jg).any()
  np.testing.assert_array_equal(np.isnan(tg), np.isnan(jg))
  np.testing.assert_allclose(tg, jg, rtol=GRAD_RTOL, atol=2e-4, equal_nan=True)


def test_bf16_grads_match_jax_at_bf16_tolerance():
  """granite_3_2b's smoke config in bfloat16 compute.  The port's
  ``embed_lookup`` gathers and then casts, so the backward pass sums the
  gradients of repeated tokens in float32; the reference casts the table
  and then gathers, and sums them in bfloat16.  The forward values are the
  same; the gradients (``embed`` too) agree at bfloat16 tolerance."""
  jcfg, tcfg = _case("granite_3_2b", dtype="bfloat16")
  tparams, jparams = _params(tcfg, seed=1)
  batch = synthetic_batch(tcfg, B, S, step=3, device="cpu")
  assert len(torch.unique(batch["tokens"])) < batch["tokens"].numel()
  loss, _, grads = _port_grads(build_model(tcfg), tparams, batch)
  jloss, _, jgrads = _ref_grads(jcfg, jparams,
                                jdata.synthetic_batch(jcfg, B, S, step=3))
  np.testing.assert_allclose(float(loss), float(jloss), rtol=BF16_RTOL)
  _assert_grads_close(grads, jgrads, BF16_RTOL, BF16_OF_MAX)
