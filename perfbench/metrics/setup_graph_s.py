"""Host seconds of the captured step's set-up: the sum of the port's
recorded spans `graph.warmup` (each eager warm-up step) and `graph.capture`,
read from its span ring in `ssv_tpu_torch.utils.trace`, which the program
has loaded; None where the program has no such module or spans."""

import sys


def read(run):
    trace = sys.modules.get("ssv_tpu_torch.utils.trace")
    spans = [s for s in getattr(trace, "spans", ()) if s[0] in ("graph.warmup", "graph.capture")]
    return sum(t1 - t0 for _, _, t0, t1 in spans) / 1e9 if spans else None
