"""Config system: YAML -> frozen dataclasses with ``${path.to.key}`` interpolation.

The port's copy of ``sculptmate_tpu/config.py``: the reference's 3-layer
OmegaConf pattern (``tsr/utils.py:16-18``, ``sf3d/models/utils.py:42-54``)
without the omegaconf dependency. Configs are plain YAML, ``${...}``
references are resolved against the document root (a whole value takes the
referenced value, a reference inside a longer string its text), and
``parse_structured`` binds a dict onto a (possibly nested) dataclass,
dropping unknown keys unless ``strict``. ``yaml`` is imported only when a
file is read, so the package imports where it is missing.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Type, TypeVar, Union

_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")

T = TypeVar("T")


class ConfigDict(dict):
    """A dict with attribute access, for loosely-typed config blobs."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value


def _wrap(obj: Any) -> Any:
    if isinstance(obj, Mapping):
        return ConfigDict({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def _lookup(root: Mapping, dotted: str) -> Any:
    cur: Any = root
    for part in dotted.split("."):
        cur = cur[part]
    return cur


def _resolve(obj: Any, root: Mapping) -> Any:
    if isinstance(obj, str):
        m = _INTERP_RE.fullmatch(obj)
        if m:
            return _resolve(_lookup(root, m.group(1)), root)
        # partial interpolation inside a longer string
        return _INTERP_RE.sub(lambda m: str(_lookup(root, m.group(1))), obj)
    if isinstance(obj, Mapping):
        return ConfigDict({k: _resolve(v, root) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_resolve(v, root) for v in obj]
    return obj


def load_yaml_config(path_or_str: str, *, from_string: bool = False) -> ConfigDict:
    """Load YAML and resolve ``${...}`` interpolations against the root."""
    import yaml

    if from_string:
        raw = yaml.safe_load(path_or_str)
    else:
        with open(path_or_str, "r") as f:
            raw = yaml.safe_load(f)
    raw = _wrap(raw or {})
    return _resolve(raw, raw)


def _coerce(value: Any, typ: Any) -> Any:
    """Best-effort coercion of YAML scalars/containers onto dataclass field types."""
    origin = getattr(typ, "__origin__", None)
    if dataclasses.is_dataclass(typ) and isinstance(value, Mapping):
        return parse_structured(typ, value)
    if origin is Union:
        for arg in typ.__args__:
            if arg is type(None):
                if value is None:
                    return None
                continue
            try:
                return _coerce(value, arg)
            except (TypeError, ValueError):
                continue
        return value
    if origin in (list, tuple) and isinstance(value, (list, tuple)):
        args = getattr(typ, "__args__", None)
        out = [_coerce(v, args[0]) for v in value] if args else list(value)
        return tuple(out) if origin is tuple else out
    if typ is float and isinstance(value, (int, float)):
        return float(value)
    if typ is int and isinstance(value, int):
        return int(value)
    if typ is tuple and isinstance(value, list):
        return tuple(value)
    return value


def parse_structured(cls: Type[T], cfg: Optional[Mapping] = None, *, strict: bool = False) -> T:
    """Bind a mapping onto dataclass ``cls``; unknown keys are dropped unless strict.

    Nested dataclass fields recurse; lists are converted to tuples when the
    field is annotated ``tuple`` so the result stays hashable.
    """
    cfg = dict(cfg or {})
    kwargs: Dict[str, Any] = {}
    for name, field in {f.name: f for f in dataclasses.fields(cls)}.items():
        if name in cfg:
            kwargs[name] = _coerce(cfg.pop(name), _resolve_field_type(cls, field))
    if cfg and strict:
        raise ValueError(f"Unknown config keys for {cls.__name__}: {sorted(cfg)}")
    return cls(**kwargs)


def _resolve_field_type(cls: Type, field: dataclasses.Field) -> Any:
    """Resolve string annotations (from __future__ annotations) to types."""
    typ = field.type
    if isinstance(typ, str):
        import sys
        import typing

        try:
            typ = typing.get_type_hints(cls).get(field.name, Any)
        except (NameError, TypeError):
            try:
                typ = eval(typ, getattr(sys.modules.get(cls.__module__), "__dict__", {}))  # noqa: S307
            except (NameError, SyntaxError, TypeError):
                typ = Any
    return typ


def asdict(cfg: Any) -> Dict[str, Any]:
    if dataclasses.is_dataclass(cfg):
        return dataclasses.asdict(cfg)
    return dict(cfg)
