"""String-keyed registry of KV-cache policies (port of
`repro.core.cache_registry`, policies only; the layout namespace arrives
with the paged layout, ROADMAP A6).

    from repro_torch.core import cache_registry
    policy = cache_registry.make("pq", spec)

This slice registers `exact` and `pq`.  The reference's other keys raise
`NotImplementedError` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

_REGISTRY: Dict[str, type] = {}

_UNPORTED = {
    "skvq": "A8", "snapkv": "A8", "streamingllm": "A8", "pqcache": "A8",
}


def register(name: str) -> Callable[[type], type]:
  """Class decorator: `@register("pq") class PQPolicy(CachePolicy)`."""
  def deco(cls: type) -> type:
    if name in _REGISTRY and _REGISTRY[name] is not cls:
      raise ValueError(f"cache policy {name!r} already registered")
    _REGISTRY[name] = cls
    cls.name = name
    return cls
  return deco


def get(name: str) -> type:
  _ensure_builtin()
  if name in _UNPORTED:
    raise NotImplementedError(
        f"cache policy {name!r} is not ported to repro_torch yet (ROADMAP "
        f"{_UNPORTED[name]})")
  try:
    return _REGISTRY[name]
  except KeyError:
    raise KeyError(
        f"unknown cache policy {name!r}; available: {names()}") from None


def make(name: str, spec):
  """Instantiate the policy registered under `name` with a CacheSpec."""
  return get(name)(spec)


def names() -> Tuple[str, ...]:
  _ensure_builtin()
  return tuple(sorted(_REGISTRY))


def _ensure_builtin() -> None:
  # registration happens at class definition; importing cache_api is enough
  from repro_torch.core import cache_api  # noqa: F401  (cycle-safe: lazy)
