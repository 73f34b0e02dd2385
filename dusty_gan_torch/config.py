"""Hydra-compatible YAML configuration without the hydra dependency.

The port's own copy of ``dusty_gan_tpu/config.py``: ``compose`` reads the
root config, resolves its ``defaults`` list and applies ``group=choice``
and dotted-path overrides; ``Config`` is a nested dict with attribute
access; ``run_dir_for`` is the reference's run-directory template;
``save_config``/``load_config`` round-trip the resolved YAML that the
evaluation CLIs consume.
"""

from __future__ import annotations

import os
import os.path as osp
from datetime import datetime
from typing import Any, Dict, List, Optional

import yaml


class Config(dict):
    """dict with recursive attribute access."""

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value):
        self[name] = value

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return [Config.wrap(v) for v in obj]
        return obj

    def to_plain(self) -> Any:
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


def _load_yaml(path: str) -> Dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _set_dotted(cfg: Dict, dotted: str, value):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def compose(
    config_dir: str,
    overrides: Optional[List[str]] = None,
    config_name: str = "config",
) -> Config:
    """Hydra-style composition. ``overrides``: ["dataset=kitti_odometry",
    "solver.lr.alpha.gen=0.001", ...].  ``_choices`` records the selected
    group options."""
    overrides = list(overrides or [])
    root = _load_yaml(osp.join(config_dir, config_name + ".yaml"))
    defaults = root.pop("defaults", [])

    choices: Dict[str, str] = {}
    for entry in defaults:
        if isinstance(entry, dict):
            for group, choice in entry.items():
                choices[str(group)] = str(choice)
    group_overrides = {}
    dotted_overrides = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, _, val = ov.partition("=")
        if "." not in key and (key in choices
                               or osp.isdir(osp.join(config_dir, key))):
            group_overrides[key] = val
        else:
            dotted_overrides.append((key, val))
    choices.update(group_overrides)

    cfg: Dict = {}
    for group, choice in choices.items():
        path = osp.join(config_dir, group, choice + ".yaml")
        if not osp.exists(path):
            avail = sorted(
                p[:-5] for p in os.listdir(osp.join(config_dir, group))
                if p.endswith(".yaml")
            ) if osp.isdir(osp.join(config_dir, group)) else []
            raise FileNotFoundError(
                f"config group '{group}' has no option '{choice}' "
                f"(available: {avail})"
            )
        cfg[group] = _load_yaml(path)
    for k, v in root.items():
        if k != "hydra":
            cfg.setdefault(k, v)

    for key, val in dotted_overrides:
        _set_dotted(cfg, key, yaml.safe_load(val))

    cfg["_choices"] = dict(choices)
    return Config.wrap(cfg)


def run_dir_for(cfg: Config, base: str = "outputs/logs",
                now: Optional[datetime] = None) -> str:
    """outputs/logs/dataset=…/model=…/solver=…/<date>/<time>."""
    now = now or datetime.now()
    ch = cfg.get("_choices", {})
    return osp.join(
        base,
        f"dataset={ch.get('dataset', 'unknown')}",
        f"model={ch.get('model', 'unknown')}",
        f"solver={ch.get('solver', 'unknown')}",
        now.strftime("%Y-%m-%d"),
        now.strftime("%H-%M-%S"),
    )


def save_config(cfg: Config, run_dir: str) -> str:
    """Persist the resolved config like hydra's ``.hydra/config.yaml``;
    returns its path."""
    d = osp.join(run_dir, ".hydra")
    os.makedirs(d, exist_ok=True)
    plain = cfg.to_plain()
    plain.pop("_choices", None)
    path = osp.join(d, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(plain, f, sort_keys=False)
    return path


def load_config(path: str) -> Config:
    """Load a resolved config YAML (the port's, the JAX package's or a
    reference run's)."""
    return Config.wrap(_load_yaml(path))
