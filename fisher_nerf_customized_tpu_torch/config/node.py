"""Minimal YACS-style config tree.

The reference stacks three config systems (argparse TrainOptions, YACS
CfgNode, Habitat Hydra; SURVEY.md §5.6).  Here a single dependency-free tree
serves all layers while staying file-compatible with the reference's YAML
experiment configs (reference configs/base_config.py:263 get_cfg_defaults +
merge_from_file).
"""
from __future__ import annotations

import copy
from typing import Any, Mapping

import yaml


class ConfigNode(dict):
    """dict with attribute access, recursive merge, and YAML IO."""

    def __init__(self, init: Mapping[str, Any] | None = None):
        super().__init__()
        if init:
            for k, v in init.items():
                self[k] = ConfigNode(v) if isinstance(v, Mapping) and not isinstance(v, ConfigNode) else v

    # -- attribute sugar ----------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = ConfigNode(value) if isinstance(value, Mapping) and not isinstance(value, ConfigNode) else value

    def __deepcopy__(self, memo):
        out = ConfigNode()
        for k, v in self.items():
            dict.__setitem__(out, k, copy.deepcopy(v, memo))
        return out

    def clone(self) -> "ConfigNode":
        return copy.deepcopy(self)

    # -- merging ------------------------------------------------------------
    def merge_from_other(self, other: Mapping[str, Any]) -> "ConfigNode":
        for k, v in other.items():
            if isinstance(v, Mapping) and isinstance(self.get(k), ConfigNode):
                self[k].merge_from_other(v)
            else:
                self[k] = ConfigNode(v) if isinstance(v, Mapping) else v
        return self

    def merge_from_file(self, path: str) -> "ConfigNode":
        with open(path, "r") as f:
            data = yaml.safe_load(f) or {}
        return self.merge_from_other(data)

    def merge_from_list(self, opts: list) -> "ConfigNode":
        """['a.b.c', 1, 'x.y', 2] style overrides (YACS-compatible).

        Unknown keys raise KeyError, matching YACS merge_from_list: a
        typo'd `--set checkpont_interval 100` must fail loudly, not
        silently leave the real knob at its default."""
        assert len(opts) % 2 == 0, "override list must be key/value pairs"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], ConfigNode):
                    raise KeyError(
                        f"unknown config node {p!r} in override {key!r}")
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown config key {key!r} in override")
            node[parts[-1]] = value
        return self

    def freeze(self):  # YACS API compatibility; the tree stays mutable
        return self

    def defrost(self):
        return self

    # -- IO -----------------------------------------------------------------
    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, ConfigNode) else v for k, v in self.items()}

    def dump(self, path: str | None = None) -> str:
        text = yaml.safe_dump(self.to_dict(), sort_keys=False)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text
