"""The reference's ``tests/test_admission_property.py``, run against the
port (``repro.`` -> ``repro_torch.``).

Property-based fairness conformance for the admission layer.

Under sustained backlog (every tenant always has queued work), deficit
round robin must hand out pops in proportion to configured weights — for
*any* weight assignment and tenant count.  Skips cleanly without
hypothesis; a fixed-weight twin lives in tests/test_torch_admission.py.
"""

import pytest

torch = pytest.importorskip("torch")

pytest.importorskip(
    "hypothesis",
    reason="property tests need hypothesis (see requirements-dev.txt)")
from hypothesis import given, settings, strategies as st

from repro_torch.service import (AdmissionRequest, FairSharePolicy,
                                 PriorityPolicy)

pytestmark = pytest.mark.concurrency


def _req(i, tenant="default", priority=0):
  return AdmissionRequest(key=f"k{i}", spec=f"s{i}", tenant=tenant,
                          priority=priority, seq=i)


@settings(max_examples=60, deadline=None)
@given(
    weights=st.lists(st.floats(min_value=0.25, max_value=8.0,
                               allow_nan=False, allow_infinity=False),
                     min_size=2, max_size=4),
    pops=st.integers(min_value=8, max_value=96),
)
def test_fair_share_pops_track_weights_under_saturation(weights, pops):
  tenants = [f"t{i}" for i in range(len(weights))]
  wmap = dict(zip(tenants, weights))
  policy = FairSharePolicy(weights=wmap)
  # Backlog deep enough that no tenant's queue empties inside the window:
  # an always-saturated DRR schedule is the regime the guarantee covers.
  backlog = pops + 8
  seq = 0
  for _ in range(backlog):
    for t in tenants:
      policy.offer(_req(seq, tenant=t))
      seq += 1

  counts = {t: 0 for t in tenants}
  for _ in range(pops):
    req = policy.pop_next()
    assert req is not None
    counts[req.tenant] += 1
  assert sum(counts.values()) == pops
  for t in tenants:
    assert policy.depth(t) > 0, "window left the saturated regime"

  # DRR guarantee: per-tenant service lags its weighted share by at most
  # one quantum grant (rounded pops) plus the in-flight visit.
  total_w = sum(wmap.values())
  for t in tenants:
    expected = pops * wmap[t] / total_w
    slack = policy.quantum * wmap[t] + 2.0
    assert abs(counts[t] - expected) <= slack, (
        f"{t}: {counts[t]} pops vs expected {expected:.1f} "
        f"(weights={wmap}, pops={pops})")


@settings(max_examples=40, deadline=None)
@given(priorities=st.lists(st.integers(min_value=0, max_value=5),
                           min_size=1, max_size=24))
def test_priority_pops_are_sorted_by_class(priorities):
  policy = PriorityPolicy()
  for i, pr in enumerate(priorities):
    policy.offer(_req(i, priority=pr))
  popped = []
  while True:
    req = policy.pop_next()
    if req is None:
      break
    popped.append(req)
  assert len(popped) == len(priorities)
  # Classes strictly non-increasing; FIFO (seq ascending) within a class.
  for a, b in zip(popped, popped[1:]):
    assert a.priority >= b.priority
    if a.priority == b.priority:
      assert a.seq < b.seq
