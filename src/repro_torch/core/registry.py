"""Calculator registry (paper §3.4: each calculator included in a program is
registered with the framework so GraphConfig can reference it by name)."""
from __future__ import annotations

from typing import Dict, Type

from .calculator import Calculator

_CALCULATORS: Dict[str, Type[Calculator]] = {}
_SUBGRAPHS: Dict[str, "object"] = {}  # name -> GraphConfig (set by graph_config)


def register_calculator(cls: Type[Calculator] = None, *, name: str = None):
    """Class decorator: ``@register_calculator`` or
    ``@register_calculator(name="Foo")``."""
    def _register(c: Type[Calculator]) -> Type[Calculator]:
        key = name or c.__name__
        existing = _CALCULATORS.get(key)
        if existing is not None and existing is not c:
            raise ValueError(f"calculator {key!r} already registered to {existing}")
        _CALCULATORS[key] = c
        return c

    if cls is None:
        return _register
    return _register(cls)


def get_calculator(name: str) -> Type[Calculator]:
    try:
        return _CALCULATORS[name]
    except KeyError:
        raise KeyError(
            f"calculator {name!r} is not registered; known: {sorted(_CALCULATORS)}"
        ) from None


def is_registered(name: str) -> bool:
    return name in _CALCULATORS


def register_subgraph(name: str, config) -> None:
    _SUBGRAPHS[name] = config


def get_subgraph(name: str):
    return _SUBGRAPHS.get(name)


def registered_calculators() -> Dict[str, Type[Calculator]]:
    return dict(_CALCULATORS)
