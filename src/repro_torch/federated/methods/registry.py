"""Method registry — maps ``--method`` names to Strategy classes (the
JAX package's ``repro.federated.methods.registry``).

Single source of truth for which federated methods exist: CLI choices,
the aggregation-compatibility grid (Table 4), and benchmark sweeps all
derive from ``available_methods()`` instead of literal lists.
"""
from __future__ import annotations

from typing import Dict, List, Type

from repro_torch.federated.methods.base import Strategy

_REGISTRY: Dict[str, Type[Strategy]] = {}


def register(name: str = ""):
    """Class decorator: ``@register()`` uses ``cls.name``; ``@register
    ("alias")`` registers under an explicit name."""
    def deco(cls: Type[Strategy]) -> Type[Strategy]:
        key = name or cls.name
        if not key:
            raise ValueError(f"{cls.__name__} has no method name")
        if key in _REGISTRY:
            raise ValueError(f"method {key!r} already registered "
                             f"({_REGISTRY[key].__name__})")
        cls.name = key
        _REGISTRY[key] = cls
        return cls
    return deco


def unregister(name: str) -> None:
    """Remove a method (tests; plugin teardown)."""
    _REGISTRY.pop(name, None)


def available_methods() -> List[str]:
    return sorted(_REGISTRY)


def get_strategy(name: str) -> Type[Strategy]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown federated method {name!r}; "
            f"available: {', '.join(available_methods())}") from None


def make_strategy(name: str, cfg, fed) -> Strategy:
    return get_strategy(name)(cfg, fed)
