"""String-keyed registries of KV-cache policies and cache layouts (port of
`repro.core.cache_registry`).

    from repro_torch.core import cache_registry
    policy = cache_registry.make("pq", spec)
    layout = cache_registry.make_layout("paged", model, max_batch)

Every policy of the reference is registered (`exact`, `pq`, `pqcache`,
`skvq`, `snapkv`, `streamingllm`), and the layouts `contiguous` and `paged`;
the `tiered` layout raises `NotImplementedError` naming the ROADMAP item
that ports it.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

_REGISTRY: Dict[str, type] = {}
_LAYOUTS: Dict[str, type] = {}

_UNPORTED_LAYOUTS = {"tiered": "A9"}


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


# ---------------------------------------------------------------------------
# cache layouts
# ---------------------------------------------------------------------------

def register_layout(name: str) -> Callable[[type], type]:
  """Class decorator: `@register_layout("paged") class PagedLayout(...)`."""
  def deco(cls: type) -> type:
    if name in _LAYOUTS and _LAYOUTS[name] is not cls:
      raise ValueError(f"cache layout {name!r} already registered")
    _LAYOUTS[name] = cls
    cls.name = name
    return cls
  return deco


def get_layout(name: str) -> type:
  _ensure_builtin_layouts()
  if name in _UNPORTED_LAYOUTS:
    raise NotImplementedError(
        f"cache layout {name!r} is not ported to repro_torch yet (ROADMAP "
        f"{_UNPORTED_LAYOUTS[name]})")
  try:
    return _LAYOUTS[name]
  except KeyError:
    raise KeyError(
        f"unknown cache layout {name!r}; available: {layout_names()}"
    ) from None


def make_layout(name: str, model, max_batch: int, **kwargs):
  """Instantiate the layout registered under `name` for a built Model."""
  return get_layout(name)(model, max_batch, **kwargs)


def layout_names() -> Tuple[str, ...]:
  _ensure_builtin_layouts()
  return tuple(sorted(_LAYOUTS))


def _ensure_builtin_layouts() -> None:
  from repro_torch.core import cache_layout  # noqa: F401  (cycle-safe: lazy)
