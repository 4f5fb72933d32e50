"""Small shared helpers: the dtype map and the device choice."""
from __future__ import annotations

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}


def torch_dtype(name: str) -> torch.dtype:
  """Config `dtype_str` -> torch dtype."""
  try:
    return _DTYPES[name]
  except KeyError:
    raise ValueError(f"unknown dtype {name!r}; choose from {sorted(_DTYPES)}"
                     ) from None


def resolve_device(device) -> torch.device:
  """The device an entry point runs on.  A CUDA device without a card raises:
  nothing falls back to the CPU unless the caller asked for it."""
  dev = torch.device(device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "CUDA is not available; pass device='cpu' (--device cpu) to run on "
        "the CPU")
  if dev.type not in ("cuda", "cpu"):
    raise ValueError(f"unsupported device {device!r}")
  return dev

