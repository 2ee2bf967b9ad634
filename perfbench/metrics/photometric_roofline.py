"""The photometric kernel's share of its roofline, in percent: the least
time the card needs for one call at the cell's batch (the frozen byte and
operation count of `counts/photometric.py`; the hue and gray rows in
expectation over the transform's draws) over the kernel's mean time a
launch in the profiled part."""

from ..counts import photometric


def read(run):
    prof, peaks = run.get("profile"), run.get("peaks")
    if prof is None or peaks is None:
        return None
    times = [b - a for name, a, b in prof["ops"] if photometric.KERNEL in name]
    if not times:
        return None
    h, w = run["hw"]
    view_cfg = run["config"]["data"]["transforms"]["train"]
    hue, gate = photometric.expected_rows(run["batch"], view_cfg)
    least, by = photometric.least_seconds(photometric.nbytes(run["batch"], h, w),
                                          photometric.float_ops(run["batch"], h, w, hue, gate),
                                          peaks)
    mean_s = sum(times) / len(times) / 1e6
    print(f"[perfbench] photometric_roofline: {len(times)} launches, {mean_s * 1e6:.3f} us each; "
          f"bound by {by}, {least * 1e6:.4f} us | {run['card_line']}")
    return 100.0 * least / mean_s
