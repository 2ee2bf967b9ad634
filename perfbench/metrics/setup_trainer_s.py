"""Host seconds of the port's `Trainer.__init__`: the sum of its recorded
spans `setup.*` (config, pipeline, algorithm, state, load), read from the
port's span ring in `ssv_tpu_torch.utils.trace`, which the program has
loaded; None where the program has no such module or spans."""

import sys


def read(run):
    trace = sys.modules.get("ssv_tpu_torch.utils.trace")
    spans = [s for s in getattr(trace, "spans", ()) if s[0].startswith("setup.")]
    return sum(t1 - t0 for _, _, t0, t1 in spans) / 1e9 if spans else None
