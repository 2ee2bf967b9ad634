"""The 95th percentile of the intervals between consecutive steps over
every step of an untraced run's window: CUDA events recorded on the card's
stream after each `Trainer.step`; the first step of an epoch carries its
boundary (the metrics read on the host, the next index matrix)."""

import statistics


def read(run):
    if run.get("unprofiled") is not None:
        return None
    ms = run["step_ms"]
    return statistics.quantiles(ms, n=20)[18] if len(ms) >= 20 else None
