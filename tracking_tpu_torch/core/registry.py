"""Algorithm registry of the port: name / type id -> algorithm class
(counterpart of ``tracking_tpu/core/registry.py``)."""

from __future__ import annotations

from typing import Dict, Iterable, Optional

_BY_NAME: Dict[str, type] = {}
_BY_TYPE_ID: Dict[int, type] = {}


def register(name: str, type_id: Optional[int] = None, aliases: Iterable[str] = ()):
    """Class decorator: register an algorithm under its reference name."""

    def deco(cls: type) -> type:
        cls.name = name
        cls.type_id = type_id
        _BY_NAME[name.lower()] = cls
        for a in aliases:
            _BY_NAME[a.lower()] = cls
        if type_id is not None:
            _BY_TYPE_ID[type_id] = cls
        return cls

    return deco


def _ensure_populated() -> None:
    import tracking_tpu_torch.bgs  # noqa: F401  (registers the ported algorithms)


def get_algorithm(key) -> type:
    """Look up a ported algorithm class by name, alias or type id."""
    _ensure_populated()
    if isinstance(key, int):
        if key not in _BY_TYPE_ID:
            raise KeyError(f"no ported algorithm with type id {key}")
        return _BY_TYPE_ID[key]
    k = str(key).lower()
    if k not in _BY_NAME:
        raise KeyError(f"no ported algorithm named {key!r}; known: {sorted(set(_BY_NAME))}")
    return _BY_NAME[k]


def list_algorithms() -> Dict[str, type]:
    _ensure_populated()
    return {cls.name: cls for cls in dict.fromkeys(_BY_NAME.values())}
