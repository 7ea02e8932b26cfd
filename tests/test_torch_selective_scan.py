"""The selective-scan kernel's plain version and wrapper against the JAX
package.

* The port's ``selective_scan_ref`` and the ``selective_scan`` wrapper on
  CPU tensors (its plain version) against the JAX ``selective_scan_ref``
  and ``selective_scan_pallas`` in interpret mode, as
  ``tests/test_kernels.py`` runs it, on its shapes and chunk pairs.
* ``dt = 0`` (the state stays at 0) and a NaN in ``u``.
* The wrapper takes the inputs the JAX kernel takes: ragged
  ``seq_chunk`` / ``c_tile`` are refused by both.
* The lanes per channel the kernel runs, chosen from the shape.
* On a card only: the kernel against its plain version, at shapes that run
  each choice of lanes.

Tolerance: the reference's own, rtol 2e-4 / atol 2e-5 (the kernel and the
two plain versions sum the N products in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ref_selective_scan import (  # noqa: E402
    selective_scan_ref as j_selective_scan_ref)
from repro.kernels.selective_scan import selective_scan_pallas  # noqa: E402
from repro_torch.kernels import selective_scan as smod  # noqa: E402
from repro_torch.kernels.ref_selective_scan import (  # noqa: E402
    selective_scan_ref)

RTOL, ATOL = 2e-4, 2e-5


def make_inputs(rng, b, s, c, n):
  """u, dt, a, bmat, cmat as float32 numpy arrays (the JAX test's draws)."""
  u = rng.standard_normal((b, s, c)).astype(np.float32)
  dt = (np.log1p(np.exp(rng.standard_normal((b, s, c)))) * 0.1
        ).astype(np.float32)
  a = -np.exp(rng.standard_normal((c, n))).astype(np.float32)
  bm = rng.standard_normal((b, s, n)).astype(np.float32)
  cm = rng.standard_normal((b, s, n)).astype(np.float32)
  return u, dt, a, bm, cm


def _torch(arrays):
  return [torch.from_numpy(x) for x in arrays]


@pytest.mark.parametrize("shape", [(1, 16, 8, 4), (2, 32, 16, 8),
                                   (2, 64, 32, 16)])
@pytest.mark.parametrize("chunks", [(8, 8), (16, 16)])
def test_matches_jax(shape, chunks):
  sc, ct = chunks
  rng = np.random.default_rng(sum(shape) * 100 + sc)
  arrays = make_inputs(rng, *shape)
  jargs = [jnp.asarray(x) for x in arrays]
  y_pallas = np.asarray(selective_scan_pallas(*jargs, seq_chunk=sc,
                                              c_tile=ct))
  y_jref = np.asarray(j_selective_scan_ref(*jargs))
  y_ref = selective_scan_ref(*_torch(arrays)).numpy()
  before = smod.launches
  y = smod.selective_scan(*_torch(arrays), seq_chunk=sc, c_tile=ct)
  assert smod.launches == before  # the plain version is no kernel launch
  assert y.dtype == torch.float32 and y.shape == shape[:3]
  np.testing.assert_allclose(y_ref, y_jref, rtol=RTOL, atol=ATOL)
  np.testing.assert_allclose(y.numpy(), y_pallas, rtol=RTOL, atol=ATOL)


def test_dt_zero_keeps_state_at_zero():
  rng = np.random.default_rng(1)
  u, dt, a, bm, cm = make_inputs(rng, 2, 16, 8, 4)
  dt[:] = 0.0
  y = smod.selective_scan(*_torch((u, dt, a, bm, cm)))
  y_j = np.asarray(selective_scan_pallas(
      *(jnp.asarray(x) for x in (u, dt, a, bm, cm))))
  assert not y.any() and not y_j.any()


def test_nan_in_u_propagates_like_jax():
  rng = np.random.default_rng(2)
  u, dt, a, bm, cm = make_inputs(rng, 2, 16, 8, 4)
  u[0, 5, 3] = np.nan
  u[1, 0, 0] = np.nan
  y = smod.selective_scan(*_torch((u, dt, a, bm, cm)), seq_chunk=8,
                          c_tile=8).numpy()
  y_j = np.asarray(selective_scan_pallas(
      *(jnp.asarray(x) for x in (u, dt, a, bm, cm)), seq_chunk=8, c_tile=8))
  # From the NaN step on, that channel's state and output are NaN.
  assert np.isnan(y[0, 5:, 3]).all() and not np.isnan(y[0, :5]).any()
  np.testing.assert_array_equal(np.isnan(y), np.isnan(y_j))
  np.testing.assert_allclose(y, y_j, rtol=RTOL, atol=ATOL, equal_nan=True)


@pytest.mark.parametrize("seq_chunk,c_tile", [(16, 8), (8, 8), (32, 12)])
def test_ragged_tiles_refused_like_jax(seq_chunk, c_tile):
  """(B,S,C,N) = (1,24,12,4): S % 16 and C % 8 are ragged; (32, 12) cut to
  (24, 12) is whole."""
  arrays = make_inputs(np.random.default_rng(3), 1, 24, 12, 4)
  ragged = 24 % min(seq_chunk, 24) or 12 % min(c_tile, 12)
  if ragged:
    with pytest.raises(AssertionError):
      selective_scan_pallas(*(jnp.asarray(x) for x in arrays),
                            seq_chunk=seq_chunk, c_tile=c_tile)
    with pytest.raises(ValueError, match="must divide"):
      smod.selective_scan(*_torch(arrays), seq_chunk=seq_chunk,
                          c_tile=c_tile)
  else:
    y = smod.selective_scan(*_torch(arrays), seq_chunk=seq_chunk,
                            c_tile=c_tile)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(j_selective_scan_ref(
            *(jnp.asarray(x) for x in arrays))), rtol=RTOL, atol=ATOL)


def test_wrapper_checks_shapes_and_casts():
  u, dt, a, bm, cm = _torch(make_inputs(np.random.default_rng(4), 1, 8, 4, 2))
  with pytest.raises(ValueError, match=r"\[C,N\]"):
    smod.selective_scan(u, dt, a[:3], bm, cm)
  with pytest.raises(ValueError, match=r"\[B,S,N\]"):
    smod.selective_scan(u, dt, a, bm[:, :4], cm)
  y16 = smod.selective_scan(u.half(), dt, a, bm, cm.double())
  assert y16.dtype == torch.float32
  torch.testing.assert_close(
      y16, selective_scan_ref(u.half().float(), dt, a, bm, cm.double().float()))


def test_kernel_matches_plain_on_card():
  """The CUDA kernel itself; runs only where a card is present."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
  rng = np.random.default_rng(5)
  shapes = [(1, 16, 8, 4), (2, 100, 200, 16), (3, 64, 130, 5)] + [
      shape for shape, _ in LANES_BY_SHAPE]
  for shape in shapes:
    arrays = [x.cuda() for x in _torch(make_inputs(rng, *shape))]
    before = smod.launches
    y = smod.selective_scan(*arrays, seq_chunk=shape[1], c_tile=shape[2])
    assert smod.launches == before + 1
    want = selective_scan_ref(*arrays)
    torch.testing.assert_close(y, want, rtol=RTOL, atol=ATOL)


LANES_BY_SHAPE = [  # (B, S, C, N) -> lanes per channel
    ((4, 8, 8192, 16), 2), ((2, 8, 8192, 16), 4), ((1, 8, 8192, 16), 8),
    ((2, 8, 64, 16), 16)]


@pytest.mark.parametrize("shape,lanes", LANES_BY_SHAPE)
def test_lanes_for_shape(shape, lanes):
  """The fewest lanes that give the grid 2^16 threads, 16 at most."""
  b, _, c, _ = shape
  assert smod.lanes_for(b, c) == lanes


SCAN_CUDA_REFUSALS = {  # what -> (change to the inputs, message)
    "cpu_tensors": (None, "CUDA device"),
    "float64": (lambda xs: [xs[0].double()] + xs[1:], "float32"),
    "strided": (lambda xs: [xs[0].transpose(1, 2).contiguous().transpose(1, 2)]
                + xs[1:], "contiguous"),
    "wide_state": (lambda xs: xs, "N=17"),
}


@pytest.mark.parametrize("what", sorted(SCAN_CUDA_REFUSALS))
def test_scan_cuda_refuses(what):
  """The kernel's launcher refuses, before any build, what it cannot run."""
  change, match = SCAN_CUDA_REFUSALS[what]
  n = 17 if what == "wide_state" else 2
  arrays = _torch(make_inputs(np.random.default_rng(6), 1, 8, 4, n))
  if change is not None:
    arrays = change(arrays)
  with pytest.raises(ValueError, match=match):
    smod.scan_cuda(*arrays)
