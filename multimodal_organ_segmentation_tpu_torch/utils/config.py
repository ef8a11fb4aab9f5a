"""Configuration tree: a copy of the JAX package's ``utils/config.py``
(``ConfigNode``, ``load_config``, ``default_config``, ``save_config``,
``merge_config_with_args``).

``yaml`` is imported inside the functions that read or write YAML only: a
config built as a Python dict needs no PyYAML.
"""

from __future__ import annotations

import copy
import datetime
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


def save_config(config, path) -> None:
    """Save config to YAML, stripping ``_``-prefixed runtime keys."""
    import yaml

    data = config.to_dict() if isinstance(config, ConfigNode) else dict(config)
    data = {k: v for k, v in data.items() if not str(k).startswith("_")}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(data, f, default_flow_style=False, sort_keys=False)


def merge_config_with_args(
    config: ConfigNode, args, schema: Optional[ConfigNode] = None
) -> ConfigNode:
    """Merge CLI args into the config tree.

    The experiment/hardware/training/model/modalities/analysis/
    explainability overrides, plus a ``_args`` stash of runtime-only flags.

    ``schema`` is an optional second config (the shipped default.yaml) whose
    keys are also accepted by the strict ``--set`` check: user configs don't
    layer over defaults, so a documented feature key may be absent from the
    loaded file while still being a real knob the code reads via ``.get()``.
    """
    import yaml

    mapping = {
        "exp_name": "experiment.name",
        "output_dir": "experiment.output_dir",
        "seed": "experiment.seed",
        "device": "hardware.device",
        "num_workers": "hardware.num_workers",
        "epochs": "training.epochs",
        "batch_size": "training.batch_size",
        "lr": "training.optimizer.lr",
        "model": "model.name",
        "fusion": "model.fusion.type",
        "modalities": "data.modalities",
        "pretrained": "model.pretrained",
    }
    for attr, path in mapping.items():
        value = getattr(args, attr, None)
        if value is not None:
            config.set(path, value)

    # generic dotted-path overrides (--set key=value, repeatable). Values are
    # YAML-parsed so booleans, numbers and lists come through typed. The key
    # must already exist in the loaded config or the schema (a typo would
    # otherwise silently create a dead key); prefix with ``+`` to create one.
    for kv in getattr(args, "overrides", None) or []:
        key, sep, raw = kv.partition("=")
        key = key.strip()
        if not sep or not key:
            raise ValueError(
                f"--set expects KEY=VALUE with a dotted config path, got {kv!r}"
            )
        create = key.startswith("+")
        if create:
            key = key[1:]
            if not key:
                raise ValueError(
                    f"--set expects KEY=VALUE with a dotted config path, got {kv!r}"
                )
        _missing = object()
        existing = config.get(key, _missing)
        known = existing is not _missing or (
            schema is not None and schema.get(key, _missing) is not _missing
        )
        if not known and not create:
            raise ValueError(
                f"--set: unknown config key {key!r} (not in the loaded config"
                f" or the default schema); check for typos, or use"
                f" --set +{key}=... to create it"
            )
        try:
            value = yaml.safe_load(raw) if raw.strip() else None
        except yaml.YAMLError as e:
            raise ValueError(f"--set {kv!r}: value is not valid YAML: {e}") from e
        # YAML 1.1 coerces no/on/off to bool and 2024-01-01 to date objects;
        # dates are never wanted as objects, and when the existing value is a
        # string the user means a string (e.g. --set experiment.name=no).
        if existing is _missing and schema is not None:
            existing = schema.get(key, _missing)
        if isinstance(value, (datetime.date, datetime.datetime)):
            value = raw.strip()
        elif (
            isinstance(existing, str)
            and value is not None
            and not isinstance(value, str)
        ):
            value = raw.strip()
        try:
            config.set(key, value)
        except (TypeError, AttributeError) as e:
            parent = key.rsplit(".", 1)[0] if "." in key else key
            raise ValueError(
                f"--set {kv!r}: {parent!r} is not a config section"
            ) from e

    for flag, path in [
        ("suv_analysis", "analysis.suv.enabled"),
        ("tmtv_analysis", "analysis.tmtv.enabled"),
        ("histogram", "analysis.histogram.enabled"),
        ("gradcam", "explainability.gradcam.enabled"),
        ("attention_maps", "explainability.attention_maps.enabled"),
        ("tsne", "explainability.tsne.enabled"),
    ]:
        if getattr(args, flag, False):
            config.set(path, True)

    config["_args"] = {
        "mode": getattr(args, "mode", None),
        "input": getattr(args, "input", None),
        "output": getattr(args, "output", None),
        "checkpoint": getattr(args, "checkpoint", None),
        "resume": getattr(args, "resume", None),
        "verbose": getattr(args, "verbose", False),
        "debug": getattr(args, "debug", False),
        "generate_report": getattr(args, "generate_report", False),
        "port": getattr(args, "port", None),
        "format": getattr(args, "format", "torch"),
    }
    return config


def config_tp_axis(config) -> Optional[str]:
    """The tensor-parallel mesh axis a config asks for (the JAX package's
    ``parallel.mesh.config_tp_axis``): ``parallel.tp_axis`` when set, else
    "model" when ``parallel.mesh.model`` > 1, else None."""
    tp = config.get("parallel.tp_axis", None)
    if tp:
        return str(tp)
    mesh_cfg = config.get("parallel.mesh", {}) or {}
    return "model" if int(dict(mesh_cfg).get("model", 1) or 1) > 1 else None


def deep_supervision(config) -> bool:
    return str(config.get("model.head.type", "conv")) == "deep_supervision"
