"""The dense decoder as one `nn.Module` (port of `repro.models.model.Model`
for the dense family).

  model = Model(cfg, context_len, device="cuda")
  model.init(generator)                                # random weights
  logits, aux = model.forward(tokens)                  # (B, S, V), no cache
  logits, caches = model.prefill(tokens)               # builds (PQ) caches
  logits, caches = model.decode_step(token, caches, lengths)
  logits, res, pools = model.decode_step_paged(token, res, pools, tables,
                                               lengths)  # paged layout

Layers run in a Python loop; `caches` is a list with one policy state per
layer.  PQ codebooks are built layer by layer inside prefill, which bounds
the k-means temporaries to one layer (paper §III-B).
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.common.types import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import require_served
from repro_torch.core import kv_cache as kvc
from repro_torch.models import layers, transformer as tfm


class Model(nn.Module):
  def __init__(self, cfg: ModelConfig, context_len: Optional[int] = None,
               device="cuda"):
    super().__init__()
    require_served(cfg)
    if cfg.cache_layout == "tiered":
      raise NotImplementedError(
          "cache layout 'tiered' is not ported yet (ROADMAP A9)")
    if cfg.weight_quant != "none" or cfg.parallel_block:
      raise NotImplementedError(
          "int8 weights and parallel blocks are not ported yet (ROADMAP A14)")
    self.cfg = cfg
    self.device = resolve_device(device)
    self.context_len = context_len or cfg.decode_cache_len
    self.cache_policy = cfg.make_cache_policy(self.context_len, self.device)
    dt, dev = cfg.dtype, self.device

    def param(*shape):
      return nn.Parameter(torch.empty(shape, dtype=dt, device=dev),
                          requires_grad=False)
    self.embed = param(cfg.vocab_size, cfg.d_model)
    self.final_norm = nn.ParameterDict({"scale": param(cfg.d_model)})
    self.lm_head = param(cfg.d_model, cfg.vocab_size)
    self.layers = nn.ModuleList(
        tfm.DenseBlock(cfg, dev) for _ in range(cfg.n_layers))

  @torch.no_grad()
  def init(self, generator: torch.Generator) -> "Model":
    """Random weights from `generator` (on the model's device), with the
    reference's distributions."""
    cfg = self.cfg
    layers.embed_init(self.embed, generator)
    self.final_norm["scale"].fill_(1.0)
    layers.dense_init(self.lm_head, cfg.d_model, generator)
    for blk in self.layers:
      tfm.dense_block_init(blk, cfg, generator)
    return self

  def _logits(self, x: torch.Tensor) -> torch.Tensor:
    x = layers.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
    return torch.matmul(x, self.lm_head)

  @torch.no_grad()
  def forward(self, tokens: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) tokens -> (logits (B, S, V), aux 0.0 f32: the dense family
    has no MoE load-balance loss).  Inference only: the flash backward and
    `train_loss` are not ported (ROADMAP A15).  Its attention runs K7 under
    the `cuda` dispatch."""
    tokens = tokens.to(self.device)
    x = layers.embed_lookup(self.embed, tokens)
    positions = torch.arange(tokens.shape[1], device=self.device)[None, :]
    use_kernel = self.cache_policy.dispatch.use_kernel
    for blk in self.layers:
      x = tfm.dense_block_forward(blk, x, positions, self.cfg, use_kernel)
    return self._logits(x), torch.zeros((), dtype=torch.float32,
                                        device=self.device)

  @torch.no_grad()
  def prefill(self, tokens: torch.Tensor,
              lengths: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, List[Any]]:
    """(B, S) tokens -> (last-token logits (B, V), per-layer caches).

    `lengths` (B,) marks each row's true prompt length in a right-padded
    batch; logits are then taken at each row's last valid token.
    """
    cfg = self.cfg
    tokens = tokens.to(self.device)
    x = layers.embed_lookup(self.embed, tokens)
    positions = torch.arange(tokens.shape[1], device=self.device)[None, :]
    if lengths is not None:
      lengths = kvc.as_lengths(lengths, tokens.shape[0], self.device)
    caches = []
    for blk in self.layers:
      x, c = tfm.dense_block_prefill(blk, x, positions, cfg,
                                     self.cache_policy, lengths)
      caches.append(c)
    if lengths is None:
      x_last = x[:, -1]
    else:
      idx = torch.clamp(lengths.long() - 1, 0, x.shape[1] - 1)
      x_last = x[torch.arange(x.shape[0], device=self.device), idx]
    return self._logits(x_last), caches

  @torch.no_grad()
  def decode_step(self, token: torch.Tensor, caches: List[Any], lengths
                  ) -> Tuple[torch.Tensor, List[Any]]:
    """token (B,) int; lengths (B,) (or a scalar) cached tokens per request.
    Returns (logits (B, V), new per-layer caches)."""
    token = token.to(self.device)
    lengths = kvc.as_lengths(lengths, token.shape[0], self.device)
    x = layers.embed_lookup(self.embed, token[:, None])
    new_caches = []
    for blk, c in zip(self.layers, caches):
      x, c = tfm.dense_block_step(blk, x, c, lengths, self.cfg,
                                  self.cache_policy)
      new_caches.append(c)
    return self._logits(x[:, 0]), new_caches

  @torch.no_grad()
  def decode_step_paged(self, token: torch.Tensor, resident_leaves,
                        pool_leaves, tables: torch.Tensor, lengths
                        ) -> Tuple[torch.Tensor, List[Any], List[Any]]:
    """Block-table-native decode step: attention reads pooled KV in place.

    `resident_leaves` are the policy-state leaves stacked over layers
    (L, B, ...), None where the leaf is paged; `pool_leaves` the physical
    pools (P+1, L, ..., block, ...), None where the leaf is resident, shared
    by all layers and written in place; `tables` the (B, nb) int32 block
    tables on the device.  Each layer's kernel call addresses its own pool
    plane by a Python-int layer counter, so the step reads no device scalar
    back.  Returns (logits (B, V), resident leaves, pool leaves).
    """
    token = token.to(self.device)
    lengths = kvc.as_lengths(lengths, token.shape[0], self.device)
    x = layers.embed_lookup(self.embed, token[:, None])
    per_layer = []
    for layer, blk in enumerate(self.layers):
      res = [None if r is None else r[layer] for r in resident_leaves]
      x, new_res, pool_leaves = tfm.dense_block_step_paged(
          blk, x, res, pool_leaves, layer, tables, lengths, self.cfg,
          self.cache_policy)
      per_layer.append((res, new_res))
    new_resident = []
    for i, r in enumerate(resident_leaves):
      # leaves the step passes through unchanged (codebooks) keep their
      # storage; the others are restacked once per step
      if r is None or all(new[i] is old[i] for old, new in per_layer):
        new_resident.append(r)
      else:
        new_resident.append(torch.stack([new[i] for _, new in per_layer]))
    return self._logits(x[:, 0]), new_resident, pool_leaves

  def init_cache(self, batch: int) -> List[Any]:
    """Zero cache at full context capacity, one state per layer."""
    cfg = self.cfg
    return [self.cache_policy.init(batch, cfg.n_kv_heads, cfg.head_dim)
            for _ in range(cfg.n_layers)]
