"""slot_fill.serve: the mean share (%) of the server's slots in flight in a
round over the window, from its own counters (the histogram
"round.slot_utilization"); moves queries_per_s."""


def read(rec):
  c = rec.get("counters") or {}
  if not c.get("slot_util_count"):
    return None
  return 100.0 * c["slot_util_sum"] / c["slot_util_count"]
