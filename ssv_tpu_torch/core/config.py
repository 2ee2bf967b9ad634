"""Config system.

A copy of ssv_tpu/core/config.py, kept apart so that the port never imports
JAX (the JAX package's `core/__init__.py` does). Loads the reference's YAML
schema (common.py:91-94): schema-free nested
mappings, where augmentation pipelines are *order-sensitive* name->kwargs
mappings with a reserved ``apply_prob`` key (reference augmentations.py:128-144).

We wrap the raw dict in a thin `Config` view that supports both attribute and
item access plus `.get`, so algorithm code stays terse while remaining
compatible with any reference YAML file verbatim.
"""

from __future__ import annotations

import copy
from typing import Any, Iterator, Mapping

import yaml


class Config(Mapping):
    """Read-only ordered view over a nested dict (YAML preserves key order)."""

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", dict(data or {}))

    # -- mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return _wrap(self._data[key])

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def get(self, key: str, default: Any = None) -> Any:
        return _wrap(self._data.get(key, default))

    # -- attribute sugar ---------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return _wrap(self._data[key])
        except KeyError as e:
            raise AttributeError(key) from e

    def raw(self) -> dict:
        """The underlying (deep-copied) plain dict, e.g. for dumping to disk."""
        return copy.deepcopy(self._data)

    def updated(self, overrides: dict) -> "Config":
        """New Config with a shallow per-level recursive merge of overrides."""
        return Config(_merge(self._data, overrides))

    def __repr__(self) -> str:
        return f"Config({self._data!r})"


def _wrap(value: Any) -> Any:
    if isinstance(value, dict):
        return Config(value)
    return value


def _merge(base: dict, overrides: dict) -> dict:
    out = dict(base)
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str) -> Config:
    with open(path, "r") as f:
        data = yaml.safe_load(f)
    return Config(data or {})
