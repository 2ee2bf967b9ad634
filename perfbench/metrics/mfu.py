"""The whole step's share of the card's dense bf16 peak, in percent: the
analytic FLOPs an image (`counts/<algo>.py`, from the configuration's
shapes) times the images a second of the traced run's unprofiled part,
over the peak."""


def read(run):
    part, peaks = run.get("unprofiled"), run.get("peaks")
    if part is None or peaks is None or not part["seconds"]:
        return None
    return 100.0 * run["flops_per_image"] * part["images"] / part["seconds"] / peaks["bf16_flops"]
