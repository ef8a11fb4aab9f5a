"""Configuration tree: a copy of the JAX package's ``utils/config.py``
(``ConfigNode``, ``load_config``, ``default_config``).

``yaml`` is imported inside ``load_config`` only: a config built as a
Python dict needs no PyYAML.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, Iterator, Mapping, Optional


class ConfigNode(Mapping):
    """A read-mostly nested config with attribute + dotted-path access.

    >>> cfg = ConfigNode({"model": {"out_channels": 8}})
    >>> cfg.model.out_channels
    8
    >>> cfg.get("model.out_channels")
    8
    >>> cfg.get("model.missing", 3)
    3
    """

    __slots__ = ("_data",)

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", dict(data or {}))

    # -- mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._wrap(self._data[key])

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = value.to_dict() if isinstance(value, ConfigNode) else value

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    # -- attribute access --------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self._wrap(self._data[key])
        except KeyError as e:
            raise AttributeError(f"config has no key {key!r}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _wrap(value: Any) -> Any:
        return ConfigNode(value) if isinstance(value, dict) else value

    def get(self, path: str, default: Any = None) -> Any:
        """Dotted-path get: ``cfg.get("training.optimizer.lr", 1e-4)``."""
        node: Any = self._data
        for part in path.split("."):
            if isinstance(node, ConfigNode):
                node = node._data
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return self._wrap(node)

    def set(self, path: str, value: Any) -> None:
        """Dotted-path set, creating intermediate dicts."""
        parts = path.split(".")
        node = self._data
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._data)

    def copy(self) -> "ConfigNode":
        return ConfigNode(self.to_dict())

    def update_from(self, other: Mapping) -> None:
        """Deep-merge ``other`` into this config (other wins)."""
        _deep_merge(self._data, dict(other))

    def __repr__(self) -> str:  # pragma: no cover
        return f"ConfigNode({self._data!r})"


def _deep_merge(dst: Dict[str, Any], src: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in src.items():
        if isinstance(v, Mapping) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], dict(v))
        else:
            dst[k] = v
    return dst


_DEFAULT_CONFIG_PATH = Path(__file__).resolve().parents[2] / "configs" / "default.yaml"


def default_config() -> ConfigNode:
    """Load the framework's default config."""
    return load_config(_DEFAULT_CONFIG_PATH)


def load_config(path) -> ConfigNode:
    """Load a YAML config file."""
    import yaml

    with open(path, "r") as f:
        data = yaml.safe_load(f) or {}
    return ConfigNode(data)
