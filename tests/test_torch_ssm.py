"""The port's Mamba-1 layer against the JAX package, in float32.

``_causal_conv`` (with and without a decode state), ``_scan_chunked``,
``mamba1_forward`` under ``ssm_impl="assoc"`` and ``"fused"`` (the JAX
kernel in interpret mode, the port's wrapper on CPU tensors), and one
``mamba1_decode`` step, at the smoke size of ``falcon_mamba_7b`` (d_model
64, d_inner 128, N 8, chunk 8).  JAX weights are carried across with
``params_from_numpy``.

Tolerance rtol 1e-4 / atol 1e-5: float32 sums and scans combined in other
orders.  The port's ``F.softplus`` returns x above 20 where the
reference's ``logaddexp(x, 0)`` adds under 2.1e-9, equal in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=RTOL, atol=ATOL)


def _layer(impl="assoc"):
  jcfg = JC.get_smoke_config("falcon_mamba_7b").scaled(ssm_impl=impl)
  tcfg = TC.get_smoke_config("falcon_mamba_7b").scaled(ssm_impl=impl)
  params = jcommon.init_params(jssm.mamba1_defs(jcfg), jax.random.PRNGKey(0))
  # Non-trivial biases and decays: the default init has them at 0 and 1.
  rng = np.random.default_rng(7)
  params = dict(params)
  for k in ("conv_b", "dt_bias", "a_log", "d_skip"):
    params[k] = jnp.asarray(rng.normal(0.0, 0.5, params[k].shape),
                            jnp.float32)
  tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
  return jcfg, tcfg, params, tparams


def test_config_copy_matches_reference():
  assert (TC.get_smoke_config("falcon_mamba_7b").__dict__
          == JC.get_smoke_config("falcon_mamba_7b").__dict__)
  for name in JC.ARCHITECTURES:
    assert TC.get_config(name).__dict__ == JC.get_config(name).__dict__
  assert TC.get_config("falcon-mamba-7b").compute_dtype == torch.bfloat16


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
  rng = np.random.default_rng(1)
  u = rng.standard_normal((2, 5, 16)).astype(np.float32)
  w = rng.standard_normal((4, 16)).astype(np.float32)
  b = rng.standard_normal((16,)).astype(np.float32)
  st = rng.standard_normal((2, 3, 16)).astype(np.float32) if with_state else None
  want = jssm._causal_conv(jnp.asarray(u), jnp.asarray(w), jnp.asarray(b),
                           None if st is None else jnp.asarray(st))
  got = tssm._causal_conv(torch.from_numpy(u), torch.from_numpy(w),
                          torch.from_numpy(b),
                          None if st is None else torch.from_numpy(st))
  _close(got, want)


@pytest.mark.parametrize("s,chunk", [(16, 8), (24, 8), (12, 16)])
def test_scan_chunked(s, chunk):
  rng = np.random.default_rng(s + chunk)
  a = rng.uniform(0.5, 1.0, (2, s, 6, 3)).astype(np.float32)
  bx = rng.standard_normal((2, s, 6, 3)).astype(np.float32)
  h0 = rng.standard_normal((2, 6, 3)).astype(np.float32)
  hs_j, last_j = jssm._scan_chunked(jnp.asarray(a), jnp.asarray(bx),
                                    jnp.asarray(h0), chunk)
  hs_t, last_t = tssm._scan_chunked(torch.from_numpy(a), torch.from_numpy(bx),
                                    torch.from_numpy(h0), chunk)
  _close(hs_t, hs_j)
  _close(last_t, last_j)


def test_scan_chunked_refuses_ragged_chunks():
  a = torch.ones(1, 12, 2)
  with pytest.raises(ValueError, match="not divisible"):
    tssm._scan_chunked(a, a, torch.zeros(1, 2), 8)


@pytest.mark.parametrize("impl", ["assoc", "fused"])
def test_mamba1_forward(impl):
  jcfg, tcfg, params, tparams = _layer(impl)
  x = np.random.default_rng(2).standard_normal((2, 16, 64)).astype(np.float32)
  want = jssm.mamba1_forward(params, jnp.asarray(x), jcfg)
  got = tssm.mamba1_forward(tparams, torch.from_numpy(x), tcfg)
  assert got.dtype == torch.float32 and got.shape == (2, 16, 64)
  _close(got, want)


def test_mamba1_decode_step():
  jcfg, tcfg, params, tparams = _layer()
  d_inner, _, n = tssm.mamba1_dims(tcfg)
  rng = np.random.default_rng(3)
  x = rng.standard_normal((2, 1, 64)).astype(np.float32)
  state = {"conv": rng.standard_normal((2, 3, d_inner)).astype(np.float32),
           "h": rng.standard_normal((2, d_inner, n)).astype(np.float32)}
  want, wstate = jssm.mamba1_decode(
      params, jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()},
      jcfg)
  got, gstate = tssm.mamba1_decode(
      tparams, torch.from_numpy(x),
      {k: torch.from_numpy(v) for k, v in state.items()}, tcfg)
  _close(got, want)
  _close(gstate["conv"], wstate["conv"])
  _close(gstate["h"], wstate["h"])
