"""Dense decoder block with its call modes (port of the dense paths of
`repro.models.transformer`):

  - forward    : full sequence, no cache (`Model.forward`)
  - prefill    : full sequence, returns the layer's cache (any policy)
  - step       : single-token decode against the layer cache
  - step_paged : single-token decode reading pooled block storage in place

For the PQ policy, prefill is where the paper's clustering runs: the Eq. 1
importance weights come from the same q/k, and the windowed weighted k-means
compresses the body, layer by layer.  Under the `cuda` dispatch the
full-sequence attention of both forward and prefill runs K7, at any
sequence length (`layers.causal_attention`).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
from torch import nn

from repro_torch.core import importance as imp
from repro_torch.models import layers


def _params(shapes: dict, dtype, device) -> nn.ParameterDict:
  return nn.ParameterDict({
      name: nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                         requires_grad=False)
      for name, shape in shapes.items()})


class DenseBlock(nn.Module):
  """One decoder layer's parameters, in the reference's layouts."""

  def __init__(self, cfg, device):
    super().__init__()
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    dt = cfg.dtype
    self.ln1 = _params({"scale": (d,)}, dt, device)
    self.attn = _params({"wq": (d, cfg.n_heads, hd),
                         "wk": (d, cfg.n_kv_heads, hd),
                         "wv": (d, cfg.n_kv_heads, hd),
                         "wo": (cfg.n_heads, hd, d)}, dt, device)
    self.ln2 = _params({"scale": (d,)}, dt, device)
    self.mlp = _params({"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)},
                       dt, device)


def dense_block_init(p: DenseBlock, cfg, generator: torch.Generator) -> None:
  """Fill a block's parameters (the reference's distributions)."""
  d = cfg.d_model
  p.ln1["scale"].fill_(1.0)
  p.ln2["scale"].fill_(1.0)
  for name in ("wq", "wk", "wv"):
    layers.dense_init(p.attn[name], d, generator)
  layers.dense_init(p.attn["wo"], cfg.n_heads * cfg.head_dim, generator)
  layers.dense_init(p.mlp["w_gate"], d, generator)
  layers.dense_init(p.mlp["w_up"], d, generator)
  layers.dense_init(p.mlp["w_down"], cfg.d_ff, generator)


def _attn_prefill(p, x: torch.Tensor, positions: torch.Tensor, cfg, policy,
                  lengths=None) -> Tuple[torch.Tensor, Any]:
  """Attention over the full sequence AND this layer's KV cache.

  `lengths` (B,) marks true prompt lengths for right-padded batches.  The
  attention runs K7 under the `cuda` dispatch (for every policy: the
  baselines' decode has no kernel, their prefill does) and plain
  `chunked_attention` under `torch`.
  """
  scale = cfg.head_dim ** -0.5
  q, k, v = layers.attention_qkv(p, x, positions, cfg.rope_theta)
  attn = layers.causal_attention(q, k, v, scale, cfg.attn_block,
                                 policy.dispatch.use_kernel)
  out = layers.attention_out(p, attn)

  w = None
  if policy.needs_weights:
    # Eq. 1 weights per (batch, kv head) from the group's lead query head
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, s, hd)[:, :, 0]
    ln = None if lengths is None else lengths[:, None]
    w = imp.attention_importance_weights(
        qg, k, scale, t=policy.spec.recent, chunk=min(cfg.attn_block, s),
        length=ln)                                        # (B, Hkv, S)
  return out, policy.prefill(k, v, w, lengths)


def _attn_qkv_step(p, x: torch.Tensor, lengths: torch.Tensor, cfg):
  """Single-token q/k/v projection + RoPE at each row's position."""
  pos = lengths.long()[:, None]                           # (B, 1)
  q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
  k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
  v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
  q = layers.apply_rope(q, pos, cfg.rope_theta)[:, 0]    # (B, H, hd)
  k = layers.apply_rope(k, pos, cfg.rope_theta)[:, 0]
  return q, k, v[:, 0]


def _attn_step(p, x: torch.Tensor, cache, lengths: torch.Tensor, cfg,
               policy) -> Tuple[torch.Tensor, Any]:
  """Single-token attention against the cache.  x (B, 1, D), lengths (B,)."""
  q, k, v = _attn_qkv_step(p, x, lengths, cfg)
  attn, new_cache = policy.append_and_attend(cache, q, k, v, lengths)
  out = torch.einsum("bhk,hkd->bd", attn.to(x.dtype), p["wo"])
  return out[:, None, :], new_cache


def _attn_step_paged(p, x: torch.Tensor, resident, pools, layer: int,
                     tables, lengths: torch.Tensor, cfg, policy):
  """Single-token attention reading pooled block storage in place.

  `resident`/`pools` are this layer's policy-state leaves (the other kind
  None); the policy's block-native step streams pool blocks through the
  per-slot `tables` and writes only the rows this token produced.
  """
  q, k, v = _attn_qkv_step(p, x, lengths, cfg)
  attn, resident, pools = policy.append_and_attend_paged(
      resident, pools, layer, tables, q, k, v, lengths)
  out = torch.einsum("bhk,hkd->bd", attn.to(x.dtype), p["wo"])
  return out[:, None, :], resident, pools


def dense_block_forward(p: DenseBlock, x: torch.Tensor, positions, cfg,
                        use_kernel: bool) -> torch.Tensor:
  """One decoder layer over the full sequence, no cache (the reference's
  dense `dense_block_forward`; forward only, no MoE, so no aux loss)."""
  h = layers.rmsnorm(p.ln1, x, cfg.norm_eps)
  x = x + layers.self_attention(p.attn, h, positions, cfg.head_dim ** -0.5,
                                cfg.rope_theta, blk=cfg.attn_block,
                                use_kernel=use_kernel)
  h = layers.rmsnorm(p.ln2, x, cfg.norm_eps)
  return x + layers.mlp(p.mlp, h)


def dense_block_prefill(p: DenseBlock, x: torch.Tensor, positions, cfg,
                        policy, lengths=None) -> Tuple[torch.Tensor, Any]:
  h = layers.rmsnorm(p.ln1, x, cfg.norm_eps)
  attn, cache = _attn_prefill(p.attn, h, positions, cfg, policy, lengths)
  x = x + attn
  h = layers.rmsnorm(p.ln2, x, cfg.norm_eps)
  return x + layers.mlp(p.mlp, h), cache


def dense_block_step(p: DenseBlock, x: torch.Tensor, cache, lengths, cfg,
                     policy) -> Tuple[torch.Tensor, Any]:
  h = layers.rmsnorm(p.ln1, x, cfg.norm_eps)
  attn, new_cache = _attn_step(p.attn, h, cache, lengths, cfg, policy)
  x = x + attn
  h = layers.rmsnorm(p.ln2, x, cfg.norm_eps)
  return x + layers.mlp(p.mlp, h), new_cache


def dense_block_step_paged(p: DenseBlock, x: torch.Tensor, resident, pools,
                           layer: int, tables, lengths, cfg, policy):
  """One decoder layer's decode step over block-pooled KV storage: mirrors
  `dense_block_step`, with attention reading the pools in place."""
  h = layers.rmsnorm(p.ln1, x, cfg.norm_eps)
  attn, resident, pools = _attn_step_paged(
      p.attn, h, resident, pools, layer, tables, lengths, cfg, policy)
  x = x + attn
  h = layers.rmsnorm(p.ln2, x, cfg.norm_eps)
  return x + layers.mlp(p.mlp, h), resident, pools
