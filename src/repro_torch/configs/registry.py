"""Registry: --arch <id> -> ModelConfig (full + reduced smoke variant)."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_MODULES: Dict[str, str] = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "rwkv6-3b": "rwkv6_3b",
    "yi-34b": "yi_34b",
    "llama3-405b": "llama3_405b",
    "granite-3-8b": "granite_3_8b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "musicgen-medium": "musicgen_medium",
    "hymba-1.5b": "hymba_1_5b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "mistral-7b": "mistral_7b",
}

ARCHS = tuple(k for k in _MODULES if k != "mistral-7b")

# families the port does not serve yet, with the ROADMAP item that ports them
_UNPORTED_FAMILIES = {
    "moe": "A14 (models/moe.py)",
    "ssm": "A14 (models/rwkv6.py)",
    "hybrid": "A14 (models/ssm.py)",
    "vlm": "A14 (VLM cross-attention groups)",
    "audio": "A14 (musicgen frame stub)",
}


def get_arch(name: str, reduced: bool = False) -> ModelConfig:
  if name not in _MODULES:
    raise KeyError(f"unknown arch {name!r}; choose from {sorted(_MODULES)}")
  mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
  return mod.REDUCED if reduced else mod.CONFIG


def require_served(cfg: ModelConfig) -> None:
  """Raise for a family whose model code is not ported yet."""
  if cfg.family in _UNPORTED_FAMILIES:
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family is not ported to repro_torch "
        f"yet (ROADMAP {_UNPORTED_FAMILIES[cfg.family]}); only dense serves")
