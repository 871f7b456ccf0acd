"""Hierarchical config system — the Hydra-groups equivalent (port of the JAX
package's ``utils/config.py``; PyYAML is imported by the functions that
parse, so the module imports without it, and the group files are read
from the repository's ``configs/``).

Mirrors the reference's config surface (`yolo/hydra/**`: groups dataset /
backbone / yolo / neck / optimizer / scheduler / multiscaler /
experiment, CLI dotted overrides, run dirs) without taking the Hydra
dependency: YAML group files under ``configs/`` compose into one nested
dict, CLI overrides use the same ``a.b=value`` syntax (and ``group=name``
to swap a group file), interpolations ``${a.b}`` resolve after merging.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any

_INTERP = re.compile(r"\$\{([^}]+)\}")

# the repository's configs/, shared with the JAX package
CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs")


class Config(dict):
    """dict with attribute access and dotted get/set."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) else v

    def get_path(self, path: str, default=None):
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, path: str, value):
        parts = path.split(".")
        node = self
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value


def _parse_value(s: str):
    import yaml

    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def _resolve_interpolations(cfg: Config):
    def resolve(node):
        if isinstance(node, dict):
            return {k: resolve(v) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v) for v in node]
        if isinstance(node, str):
            m = _INTERP.fullmatch(node)
            if m:
                return cfg.get_path(m.group(1), node)
            return _INTERP.sub(
                lambda mm: str(cfg.get_path(mm.group(1), mm.group(0))),
                node)
        return node

    # two passes handle chained interpolations
    out = cfg
    for _ in range(2):
        out = Config(resolve(out))
    return out


def load_config(
    config_dir: str,
    overrides: list[str] | None = None,
    root: str = "config.yaml",
) -> Config:
    """Compose configs/<root> with its `defaults:` group list, apply CLI
    overrides, resolve ${} interpolations."""
    import yaml

    with open(os.path.join(config_dir, root)) as f:
        top = yaml.safe_load(f) or {}
    defaults = top.pop("defaults", [])
    cfg = Config(copy.deepcopy(top))

    group_choice = {}
    overrides = list(overrides or [])
    # group swaps (e.g. dataset=lvis) are applied when loading groups
    rest = []
    for ov in overrides:
        key, _, val = ov.partition("=")
        if "." not in key and os.path.exists(
            os.path.join(config_dir, key, f"{val}.yaml")
        ):
            group_choice[key] = val
        else:
            rest.append(ov)

    for entry in defaults:
        if isinstance(entry, dict):
            (group, name), = entry.items()
        else:
            group, name = entry, None
        name = group_choice.get(group, name)
        path = os.path.join(config_dir, group, f"{name}.yaml")
        with open(path) as f:
            cfg[group] = yaml.safe_load(f) or {}
        cfg[group]["name"] = cfg[group].get("name", name)

    for ov in rest:
        key, _, val = ov.partition("=")
        cfg.set_path(key, _parse_value(val))

    return _resolve_interpolations(cfg)
