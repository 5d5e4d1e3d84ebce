"""Config system — YAML with default tree + named overlays + meta_cfgs.

Behavioral reference: config_helper/config_helper/config.py:11-120 (the
reference's separate pip package). Semantics preserved exactly:

  * one YAML file with a `default` root and named overlay sections;
  * `!tuple` YAML tag;
  * overlays compose recursively through their `meta_cfgs` lists (depth
    first, then the overlay itself);
  * strict merge: a key set by an overlay must exist in the default tree
    (`meta_cfgs` exempt);
  * CLI `-c overlay1 overlay2 ...` plus `-kv a b c value` dotlist updates
    (update path must exist);
  * sha256 config hash for log-dir naming.

OmegaConf is not available in this environment, so the tree is a minimal
attribute-access dict (`Config`) with the same surface the code needs
(dot access, .get, .setdefault, iteration, yaml round-trip).
"""
from __future__ import annotations

import copy
import functools
import hashlib
from collections.abc import Mapping
from pathlib import Path
from typing import Any, Optional, Sequence

import yaml

from liso_tpu_torch.utils.atomic import publish_text


class Config(dict):
    """dict with attribute access, recursive over nested mappings."""

    def __init__(self, d: Optional[Mapping] = None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = v

    def __setitem__(self, k, v):
        if isinstance(v, Mapping) and not isinstance(v, Config):
            v = Config(v)
        super().__setitem__(k, v)

    __setattr__ = __setitem__

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def setdefault(self, k, default=None):
        if k not in self:
            self[k] = default
        return self[k]

    def to_dict(self) -> dict:
        def conv(v):
            if isinstance(v, Config):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, tuple):
                return list(v)
            return v

        return {k: conv(v) for k, v in self.items()}

    def select(self, dotted: str):
        """OmegaConf.select equivalent: returns None when missing."""
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return None
            node = node[part]
        return node

    def deepcopy(self) -> "Config":
        return copy.deepcopy(self)  # preserves tuples (to_dict would not)


def _yaml_load(path):
    class PythonicLoader(yaml.SafeLoader):
        pass

    PythonicLoader.add_constructor(
        "!tuple", yaml.FullLoader.construct_python_tuple
    )
    load = functools.wraps(yaml.load)(
        functools.partial(yaml.load, Loader=PythonicLoader)
    )
    with open(path, "r") as f:
        return load(f)


def load_yaml_config(path) -> Config:
    """dumb_load_yaml_to_omegaconf equivalent."""
    return Config(_yaml_load(path))


def update_nested_dict(d: Config, other: Mapping):
    """config.py:27-34 — strict key-exists merge."""
    for k, v in other.items():
        d_v = d.get(k)
        if isinstance(v, Mapping) and isinstance(d_v, Mapping):
            update_nested_dict(d_v, v)
        else:
            assert k == "meta_cfgs" or k in d, (
                f"default value for key {k} not found!"
            )
            d[k] = copy.deepcopy(v)


def recursive_cfg_update(full_cfg: Config, cfg: Config, overlay_name: str):
    """config.py:37-46 — depth-first meta_cfgs composition."""
    overlay = full_cfg[overlay_name]
    if "meta_cfgs" in overlay:
        assert not isinstance(overlay["meta_cfgs"], str), "string not allowed"
        for meta_name in overlay["meta_cfgs"]:
            recursive_cfg_update(full_cfg, cfg, meta_name)
    update_nested_dict(cfg, overlay)


def _parse_value(s: str):
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def parse_config(
    cfg_path,
    extra_cfg_args: Sequence[str] = (),
    key_value_updates: Optional[Sequence[Sequence[str]]] = None,
) -> Config:
    """config.py:49-98."""
    file_cfg = load_yaml_config(cfg_path)
    cfg = file_cfg["default"].deepcopy()
    for overlay in extra_cfg_args:
        recursive_cfg_update(file_cfg, cfg, overlay)
    for kv in key_value_updates or ():
        assert len(kv) >= 2, kv
        for el in kv:
            assert "=" not in el, f"char = not allowed in keyword update: {el}"
        path, value = kv[:-1], kv[-1]
        # accept both "-kv a b c value" (reference style) and
        # "-kv a.b.c value" — a dotted token otherwise passes the select()
        # existence check below yet would write a literal "a.b.c" key
        path = [seg for el in path for seg in str(el).split(".")]
        dotted = ".".join(path)
        assert cfg.select(dotted) is not None, (
            f"you are updating keys that do not exist in default config: "
            f"{dotted}"
        )
        node = cfg
        for part in path[:-1]:
            node = node[part]
        node[path[-1]] = _parse_value(value)
    return cfg


def to_plain(cfg_node):
    """Config tree -> plain dicts and lists, for yaml dumps."""
    if hasattr(cfg_node, "items"):
        return {k: to_plain(v) for k, v in cfg_node.items()}
    if isinstance(cfg_node, (list, tuple)):
        return [to_plain(v) for v in cfg_node]
    return cfg_node


def config_to_yaml(cfg: Config) -> str:
    return yaml.safe_dump(cfg.to_dict(), sort_keys=False)


def save_config(cfg: Config, path):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    # whole or not at all: a resume's config check reads it
    publish_text(path, config_to_yaml(cfg))


def get_config_hash(cfg: Config) -> str:
    """config.py:112-116 (sha256 of the yaml dump)."""
    return hashlib.sha256(config_to_yaml(cfg).encode("utf-8")).hexdigest()
