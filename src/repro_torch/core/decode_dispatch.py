"""Decode-kernel dispatch registry: which implementation runs the decode
attention hot path (the port's counterpart of `repro.core.decode_dispatch`).

  ``torch``  the plain PyTorch path (`core.pq_attention`, `core.kv_cache`);
             runs on any device and is the reference the kernels are held to.
  ``cuda``   the hand-written CUDA kernels (`kernels/pq_decode.py`,
             `kernels/paged_flash_decode.py`).  Needs CUDA tensors on an
             sm_90 card; anything else raises when the policy is built.
  ``auto``   decided by the device the cache lives on: a CPU device takes
             ``torch``, a CUDA device takes ``cuda`` (and so raises where
             ``cuda`` would).  Never decided by whether a GPU is present.

Resolution happens once, when a policy is built (`resolve(name, device)`);
there is no per-step branching and no fallback from a kernel to the plain
path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DecodeDispatch:
  """Resolved decode-kernel choice; `use_kernel` selects the CUDA kernels."""
  name: str
  use_kernel: bool

  @property
  def key(self) -> str:
    """Stable identifier for stats records."""
    return "cuda" if self.use_kernel else "torch"


_RESOLVERS: Dict[str, Callable[[torch.device], DecodeDispatch]] = {}


def register(name: str):
  def deco(fn):
    if name in _RESOLVERS and _RESOLVERS[name] is not fn:
      raise ValueError(f"decode kernel {name!r} already registered")
    _RESOLVERS[name] = fn
    return fn
  return deco


def names() -> Tuple[str, ...]:
  return tuple(sorted(_RESOLVERS))


def validate(name: str) -> None:
  """Cheap config-time check: is the key known?"""
  if name not in _RESOLVERS:
    raise ValueError(
        f"unknown decode kernel {name!r}; available: {names()}")


def resolve(name: str, device) -> DecodeDispatch:
  """Resolve a registry key against the device the cache lives on."""
  validate(name)
  return _RESOLVERS[name](torch.device(device))


def require_sm90(device: torch.device) -> None:
  """The kernels are built for sm_90a: refuse anything else loudly."""
  if device.type != "cuda":
    raise ValueError(
        f"the CUDA decode kernels need a CUDA device, got {device}; use "
        f"decode kernel 'torch' or 'auto' on the CPU")
  if not torch.cuda.is_available():
    raise RuntimeError("CUDA decode kernels requested but CUDA is not "
                       "available")
  cap = torch.cuda.get_device_capability(device)
  if cap != (9, 0):
    raise RuntimeError(
        f"the CUDA decode kernels are built for sm_90a (H100/H200); "
        f"{torch.cuda.get_device_name(device)} is sm_{cap[0]}{cap[1]}")


@register("torch")
def _torch(device: torch.device) -> DecodeDispatch:
  del device
  return DecodeDispatch(name="torch", use_kernel=False)


@register("cuda")
def _cuda(device: torch.device) -> DecodeDispatch:
  require_sm90(device)
  return DecodeDispatch(name="cuda", use_kernel=True)


@register("auto")
def _auto(device: torch.device) -> DecodeDispatch:
  if device.type == "cuda":
    require_sm90(device)
    return DecodeDispatch(name="auto", use_kernel=True)
  return DecodeDispatch(name="auto", use_kernel=False)
