"""Minimal Hydra-compatible config loading over the shared ``configs/``.

Counterpart of ``perf_tpu/config.py``: a root YAML chosen by
``--config-name``, a ``defaults`` list composing group files, dotted
``key=value`` overrides with YAML-typed values. PyYAML is imported when a
config is loaded, not when this module is imported.
"""

from __future__ import annotations

import copy
import os


class Config(dict):
    """Nested dict with dotted-path lookup."""

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def get_path(self, dotted: str, default=None):
        node = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def _deep_merge(base: dict, extra: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _set_dotted(cfg: dict, dotted: str, value):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def load_config(config_dir: str, config_name: str, overrides=()) -> Config:
    import yaml
    with open(os.path.join(config_dir, config_name + ".yaml")) as f:
        root = yaml.safe_load(f) or {}
    defaults = root.pop("defaults", [])
    cfg: dict = {}
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            cfg = _deep_merge(cfg, root)
            self_merged = True
            continue
        if not (isinstance(entry, dict) and len(entry) == 1):
            raise ValueError(f"bad defaults entry {entry!r}")
        (group, name), = entry.items()
        with open(os.path.join(config_dir, group, f"{name}.yaml")) as f:
            cfg = _deep_merge(cfg, {group: yaml.safe_load(f) or {}})
    if not self_merged:
        cfg = _deep_merge(cfg, root)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, _, raw = ov.partition("=")
        _set_dotted(cfg, key.strip(), yaml.safe_load(raw))
    return Config.wrap(cfg)
