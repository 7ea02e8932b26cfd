"""level_idle_ms.bc: card-idle milliseconds a trial while the host's
innermost operation is one of BC's spans (the forward pass, the backward
pass, a level of the sweep), from the traced window's idle gaps by host
operation; moves gteps."""

SPANS = ("graphmat.algos.bc.forward", "graphmat.algos.bc.backward",
         "graphmat.engine.level")


def read(rec):
  summary = rec.get("summary")
  if not summary or not rec.get("trials"):
    return None
  idle = summary["idle_s_by_host"]
  return 1e3 * sum(idle.get(name, 0.0) for name in SPANS) / rec["trials"]
