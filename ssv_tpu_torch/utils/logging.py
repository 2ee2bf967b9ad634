"""Logging and terminal progress.

The port's copy of ssv_tpu/utils/logging.py (reference utils/common.py:18-89):
colored stdout + file logger and a `\r` progress bar. wandb is optional:
without the package, `get_wandb()` returns a recorder that mirrors the wandb
API (`init`, `log`) and appends JSON lines to
`<output_dir>/wandb_offline.jsonl` instead.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

COLORS = {
    "info": "\033[96m",     # cyan
    "train": "\033[92m",    # green
    "val": "\033[93m",      # yellow
    "error": "\033[91m",    # red
    "end": "\033[0m",
}


class Logger:
    """Colored stdout + plain-text file logger (`trainlogs.txt`)."""

    def __init__(self, output_dir: str | None = None):
        self._log = logging.getLogger(f"ssv_tpu_torch.{id(self)}")
        self._log.setLevel(logging.INFO)
        self._log.propagate = False
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(output_dir, "trainlogs.txt"))
            fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
            self._log.addHandler(fh)

    def print(self, msg: str, mode: str = "info") -> None:
        color = COLORS.get(mode, "")
        label = f"{mode.upper()}: " if mode != "train" else ""
        sys.stdout.write(f"{color}{label}{msg}{COLORS['end']}\n")
        sys.stdout.flush()

    def write(self, msg: str, mode: str = "info") -> None:
        self._log.info(f"[{mode}] {msg}")
        self.print(msg, mode=mode)

    def record(self, msg: str, mode: str = "val") -> None:
        self.write(msg, mode=mode)


def progress_bar(progress: float, desc: str = "", status: str = "", width: int = 30) -> None:
    progress = min(max(progress, 0.0), 1.0)
    filled = int(width * progress)
    bar = "=" * filled + ">" + "." * (width - filled - 1) if filled < width else "=" * width
    sys.stdout.write(f"\r{desc} [{bar}] {100 * progress:5.1f}% {status}")
    if progress >= 1.0:
        sys.stdout.write("")
    sys.stdout.flush()


class _OfflineRun:
    def __init__(self, output_dir: str | None, project: str | None):
        self.project = project
        self._path = None
        if output_dir is not None:
            self._path = os.path.join(output_dir, "wandb_offline.jsonl")

    def get_url(self) -> str:
        return f"offline://{self._path or 'disabled'}"

    def log(self, metrics: dict) -> None:
        if self._path is None:
            return
        rec = {"t": time.time(), **{k: _tofloat(v) for k, v in metrics.items()}}
        with open(self._path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def finish(self) -> None:
        pass


def _tofloat(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class _WandbShim:
    """Module-like object exposing `init`/`log` whether or not wandb exists."""

    def __init__(self):
        self._run: _OfflineRun | None = None
        try:
            import wandb  # noqa: F401

            self._wandb = wandb
        except ImportError:
            self._wandb = None

    def init(self, project: str | None = None, output_dir: str | None = None, **kwargs):
        if self._wandb is not None:
            try:
                return self._wandb.init(project=project, **kwargs)
            except Exception:
                pass
        self._run = _OfflineRun(output_dir, project)
        return self._run

    def log(self, metrics: dict) -> None:
        if self._wandb is not None and self._wandb.run is not None:
            self._wandb.log(metrics)
        elif self._run is not None:
            self._run.log(metrics)


_shim: _WandbShim | None = None


def get_wandb() -> _WandbShim:
    global _shim
    if _shim is None:
        _shim = _WandbShim()
    return _shim
