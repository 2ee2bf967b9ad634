"""The DINO ViT step's share of the card's dense bf16 peak, in percent:
the analytic FLOPs an image (`counts/dino.py`: the student's forward and
backward over all crops, the teacher's forward over the global crops)
times the images a second of the traced run's unprofiled part, over the
peak (`metrics/mfu.py`)."""

from .mfu import read  # noqa: F401
