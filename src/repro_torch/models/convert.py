"""Weights carried across from the reference: the JAX `Model.init` pytree,
as nested dicts of numpy arrays with layer leaves stacked on a leading axis
of size n_layers, loaded into the port's `Model`."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.models.model import Model

_LAYER_LEAVES = (("ln1", "scale"), ("ln2", "scale"),
                 ("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                 ("attn", "wo"), ("mlp", "w_gate"), ("mlp", "w_up"),
                 ("mlp", "w_down"))


def _copy(dst: torch.Tensor, src, name: str) -> None:
  arr = np.asarray(src)
  if tuple(arr.shape) != tuple(dst.shape):
    raise ValueError(f"{name}: shape {arr.shape} != {tuple(dst.shape)}")
  # bf16 has no numpy dtype of its own: go through f32 (exact for bf16)
  dst.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))


@torch.no_grad()
def params_from_numpy(model: Model, tree: Mapping) -> Model:
  """Load the reference's params pytree `tree` into `model` (in place)."""
  _copy(model.embed, tree["embed"], "embed")
  _copy(model.final_norm["scale"], tree["final_norm"]["scale"],
        "final_norm.scale")
  _copy(model.lm_head, tree["lm_head"], "lm_head")
  stacked = tree["layers"]
  for group, leaf in _LAYER_LEAVES:
    arr = np.asarray(stacked[group][leaf])
    if arr.shape[0] != len(model.layers):
      raise ValueError(f"layers.{group}.{leaf}: {arr.shape[0]} layers, model "
                       f"has {len(model.layers)}")
    for i, blk in enumerate(model.layers):
      _copy(getattr(blk, group)[leaf], arr[i], f"layers.{group}.{leaf}[{i}]")
  return model
