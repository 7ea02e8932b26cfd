"""Float16 sums on the ELL kernel's path, on the CPU: the reference's
``ell_spmv_pallas`` (interpret mode) and the port's plain version, on the
rows of ``test_torch_ell_card.HALF_ROWS``, which the card test holds the
shipped ``msg`` instance to.

The reference sums a tile of up to 512 slots of float16 with ``jnp.sum``,
which sums in float32 and rounds once; the plain version sums a row in
float and rounds once.  So 4,000 terms of 1.0 give 4,000; 2,048 and then
3,999 terms of 1.0 give 6,048 (a sum kept in float16 stalls at 2,048: the
next integer, 2,049, is not a float16); 500 terms in [0.5, 1.5] (one tile)
come within one float16 ulp of the float64 sum, one query and eight.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ell_spmv import ell_spmv_pallas  # noqa: E402
from repro_torch.kernels import ell_spmv as kmod  # noqa: E402
from test_torch_ell_card import (HALF_ROWS, check_half_sum,  # noqa: E402
                                 half_row)


@pytest.mark.parametrize("name", HALF_ROWS)
def test_reference_half_sum(name):
  row = half_row(name)
  y, recv = ell_spmv_pallas(
      jnp.asarray(row["cols"]), jnp.asarray(row["vals"]).astype(jnp.float16),
      jnp.asarray(row["mask"]), jnp.asarray(row["msg"]).astype(jnp.float16),
      jnp.asarray(row["active"]), jnp.zeros((1, 1), jnp.float16),
      process=lambda m, e, d: m, reduce_kind="add", interpret=True)
  assert y.dtype == jnp.float16 and np.asarray(recv).tolist() == [1]
  check_half_sum(name, np.asarray(y.astype(jnp.float32)))


@pytest.mark.parametrize("name", HALF_ROWS)
def test_plain_half_sum(name):
  row = half_row(name)
  t = {k: torch.from_numpy(v) for k, v in row.items() if k != "sum"}
  y, recv = kmod.ell_spmv(t["cols"], t["vals"].half(), t["mask"],
                          t["msg"].half(), t["active"], process_op="msg",
                          reduce_kind="add")
  assert y.dtype == torch.float16 and recv.tolist() == [1]
  check_half_sum(name, y.double().numpy())


def test_a_float16_sum_stalls():
  """What the rows guard against: the same terms summed in float16, one
  after another, stop at 2,048."""
  acc = np.float16(0)
  for x in half_row("stall_6048")["msg"][:, 0].astype(np.float16):
    acc = np.float16(acc + x)
  assert acc == 2048
