"""Hierarchical YAML configs (the port's copy of
`genefaceplusplus_tpu/config/config.py`, reading and writing YAML through
`config/yaml_io.py` instead of PyYAML).

- A YAML file may declare `base_config: [path, ...]` (a str or a list).
  Bases load depth first; later files override earlier ones, and a cycle
  raises. A base starting with `.` is relative to the file; any other
  relative base is tried from the working directory, then from the file's
  directory.
- Dotted overrides `"a=1,b.c=2,lst=[1,2]"` are parsed as YAML values and
  cast to the type of the value they replace.
- A work dir carries its own `config.yaml`; `set_hparams(work_dir=...)`
  reads it back.

`Config` is an immutable mapping with attribute access.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Mapping, Optional

from genefaceplusplus_tpu_torch.config import yaml_io


def _deep_update(dst: Dict[str, Any], src: Mapping[str, Any]) -> Dict[str, Any]:
    for k, v in src.items():
        if isinstance(v, Mapping) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v if not isinstance(v, Mapping) else dict(v)
    return dst


def load_config(config_fname: str, _visited: Optional[set] = None) -> Dict[str, Any]:
    """Load a YAML config, resolving its `base_config` chain."""
    config_fname = os.path.abspath(config_fname)
    _visited = set() if _visited is None else _visited
    if config_fname in _visited:
        raise ValueError(f"base_config cycle detected at {config_fname}")
    _visited.add(config_fname)

    own: Dict[str, Any] = yaml_io.load(config_fname) or {}

    merged: Dict[str, Any] = {}
    bases = own.pop("base_config", [])
    if isinstance(bases, str):
        bases = [bases]
    for base in bases:
        if base.startswith("."):
            base = os.path.join(os.path.dirname(config_fname), base)
        elif not os.path.isabs(base):
            # relative to the working directory first, then to this file's
            if not os.path.exists(base):
                cand = os.path.join(os.path.dirname(config_fname), base)
                base = cand if os.path.exists(cand) else base
        _deep_update(merged, load_config(base, _visited))
    _deep_update(merged, own)
    return merged


_COERCE_TRUE = {"true", "True"}
_COERCE_FALSE = {"false", "False"}


def _coerce(v: str) -> Any:
    v = v.strip()
    if v in _COERCE_TRUE:
        return True
    if v in _COERCE_FALSE:
        return False
    if v in ("None", "null", ""):
        return None
    try:
        return yaml_io.loads(v)
    except yaml_io.YAMLSyntaxError:
        return v


def apply_overrides(cfg: Dict[str, Any], overrides: str) -> Dict[str, Any]:
    """Apply `"a=1,b.c=2,lst=[1,2]"`-style dotted overrides in place."""
    if not overrides:
        return cfg
    # split on commas that are not inside brackets
    parts = re.split(r",(?![^\[\(]*[\]\)])", overrides)
    for part in parts:
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"malformed override (expected k=v): {part!r}")
        key, val = part.split("=", 1)
        key = key.strip()
        if not key:
            raise ValueError(f"malformed override (empty key): {part!r}")
        node = cfg
        subkeys = key.split(".")
        for sk in subkeys[:-1]:
            node = node.setdefault(sk, {})
        new = _coerce(val)
        old = node.get(subkeys[-1])
        if isinstance(old, str) and not isinstance(new, (str, dict, list, tuple)):
            new = val.strip()  # keep string-typed keys strings ("video_id=123")
        # cast to the replaced value's type, and fail on junk
        if old is not None and not isinstance(old, (str, dict, list, tuple)) \
                and isinstance(new, str):
            try:
                new = type(old)(new) if not isinstance(old, bool) \
                    else {"true": True, "false": False}[new.lower()]
            except (ValueError, KeyError) as exc:
                raise ValueError(
                    f"override {part!r}: cannot cast {val!r} to "
                    f"{type(old).__name__} (current value {old!r})"
                ) from exc
        node[subkeys[-1]] = new
    return cfg


class Config(Mapping[str, Any]):
    """Immutable mapping over a resolved config dict with attribute access."""

    __slots__ = ("_d",)

    def __init__(self, d: Mapping[str, Any]):
        object.__setattr__(self, "_d", dict(d))

    def __getitem__(self, k: str) -> Any:
        return self._d[k]

    def __iter__(self) -> Iterator[str]:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def get(self, k: str, default: Any = None) -> Any:
        return self._d.get(k, default)

    def __getattr__(self, k: str) -> Any:
        try:
            return self._d[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __repr__(self) -> str:
        return f"Config({self._d!r})"

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._d)

    def replace(self, **kw: Any) -> "Config":
        d = dict(self._d)
        d.update(kw)
        return Config(d)


def save_config(cfg: Mapping[str, Any], work_dir: str) -> str:
    """Write `config.yaml` into a work dir."""
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, "config.yaml")
    d = cfg.to_dict() if isinstance(cfg, Config) else dict(cfg)
    with open(path, "w", encoding="utf-8") as f:
        f.write(yaml_io.dumps(d))
    return path


def set_hparams(
    config: str = "",
    exp_name: str = "",
    hparams_str: str = "",
    work_dir: Optional[str] = None,
    reset: bool = False,
) -> Config:
    """The final config. Priority, low to high: the work dir's saved
    config.yaml (unless `reset`), the YAML file `config` (or a dir holding
    config.yaml), the dotted `hparams_str` overrides."""
    cfg: Dict[str, Any] = {}
    saved = os.path.join(work_dir, "config.yaml") if work_dir else None
    if saved and os.path.exists(saved) and not reset:
        _deep_update(cfg, load_config(saved))
    if config:
        if os.path.isdir(config):
            config = os.path.join(config, "config.yaml")
        _deep_update(cfg, load_config(config))
    if exp_name:
        cfg["exp_name"] = exp_name
    apply_overrides(cfg, hparams_str)
    if work_dir:
        cfg.setdefault("work_dir", work_dir)
    return Config(cfg)
