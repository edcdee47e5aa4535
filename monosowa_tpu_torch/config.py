"""Configuration system for the pseudo-label pipeline and detector.

Behavioral contract (reference: pseudo_label_generator/3d/scripts/anno_V3.py:9-98):
YAML files parse into recursive attribute objects; missing keys resolve to
``None`` instead of raising, so configs can be sparse.  The CLI ``--action``
string expands into boolean pipeline-stage flags.

The detector side (reference: MonoDETR/tools/train_val.py:38) uses a plain
dict; we keep that too via :func:`load_yaml`.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterator, Optional


class Config:
    """Recursive attribute-access wrapper over a dict.

    Missing attributes return ``None`` (matching the reference's silent-None
    semantics, anno_V3.py:22-23) so sparse YAML configs work.
    """

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = Config(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        return self._data.get(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, dict):
            value = Config(value)
        self._data[name] = value

    def __getitem__(self, name: str) -> Any:
        return self._data[name]

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def get(self, name: str, default: Any = None) -> Any:
        v = self._data.get(name, default)
        return default if v is None else v

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, Config) else v
        return out

    def merged_under(self, defaults: "Config") -> "Config":
        """Return a new Config = defaults overridden by self (deep merge)."""
        merged = copy.deepcopy(defaults.to_dict())

        def _merge(dst: dict, src: dict) -> None:
            for k, v in src.items():
                if isinstance(v, dict) and isinstance(dst.get(k), dict):
                    _merge(dst[k], v)
                else:
                    dst[k] = v

        _merge(merged, self.to_dict())
        return Config(merged)


def load_yaml(path: str) -> Dict[str, Any]:
    """The YAML file at ``path``.  Without PyYAML (the serving image need
    not have it) only a JSON file, which is YAML too, can be read: any
    other file raises an ``ImportError`` that names PyYAML."""
    with open(path, "r") as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        import json

        try:
            return json.loads(text)
        except json.JSONDecodeError as err:
            raise ImportError(f"reading {path} needs PyYAML; without it "
                              "only a JSON config can be read") from err
    return yaml.safe_load(text)


def load_config(path: str) -> Config:
    return Config(load_yaml(path))


# ---------------------------------------------------------------------------
# Pipeline stage flags
# ---------------------------------------------------------------------------

# action -> stage-flag expansion (reference: anno_V3.py:55-98). Each CLI action
# turns on a subset of the 10 boolean stage flags that the per-frame
# loop consults.
_ACTION_FLAGS: Dict[str, Dict[str, bool]] = {
    "lidar_scans": dict(generate_raw_lidar=True),
    "transformations": dict(generate_transformations_only=True),
    "homographies": dict(generate_homographies=True),
    "mask_tracking": dict(generate_raw_masks_or_tracking=True),
    "candidates": dict(generate_candidates=True),
    "frames_aggregation": dict(generate_merged_frames_only=True),
    "optimization": dict(load_merged_frames=True, load_transformations=True,
                         do_optim=True),
    "dimensions_output": dict(load_merged_frames=True, load_transformations=True,
                              do_optim_scale=True, compute_dimensions=True),
    "demo": dict(load_merged_frames=True, load_transformations=True,
                 do_optim=True, do_optim_scale=True, compute_dimensions=True),
}

_ALL_FLAGS = (
    "generate_raw_lidar", "generate_transformations_only", "generate_homographies",
    "generate_raw_masks_or_tracking", "generate_candidates",
    "generate_merged_frames_only", "load_merged_frames", "load_transformations",
    "do_optim", "do_optim_scale", "compute_dimensions",
)


class PipelineFlags:
    """Boolean stage flags decoded from a CLI ``--action``."""

    def __init__(self, action: str):
        if action not in _ACTION_FLAGS:
            raise ValueError(
                f"unknown action {action!r}; choose from {sorted(_ACTION_FLAGS)}")
        self.action = action
        on = _ACTION_FLAGS[action]
        for f in _ALL_FLAGS:
            setattr(self, f, on.get(f, False))

    def __repr__(self) -> str:
        on = [f for f in _ALL_FLAGS if getattr(self, f)]
        return f"PipelineFlags({self.action}: {on})"


def known_actions() -> list:
    return sorted(_ACTION_FLAGS)
