"""Transformer layers: RMSNorm, split-half RoPE, causal attention (plain,
or K7 through the dispatch), GQA projections and the SiLU-gated MLP (port of
`repro.models.layers`).

Parameters are mappings of tensors in the reference's layouts (`wq`
(D, H, hd), `wo` (H, hd, D), `w_gate` (D, F), ...).  Compute runs in the
config dtype with f32 softmax and norm statistics, as the reference.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops as kops


# ---------------------------------------------------------------------------
# init helpers (the reference's distributions; the random bits differ)
# ---------------------------------------------------------------------------

def dense_init(t: torch.Tensor, in_dim: int, generator: torch.Generator
               ) -> None:
  """Fill `t` in place: truncated normal on [-2, 2] scaled by 1/sqrt(in_dim),
  drawn in f32 and cast to t's dtype."""
  w = torch.empty(t.shape, dtype=torch.float32, device=t.device)
  torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                              generator=generator)
  t.copy_(w / math.sqrt(in_dim))


def embed_init(t: torch.Tensor, generator: torch.Generator) -> None:
  """Fill `t` in place: normal * 0.02, drawn in f32."""
  w = torch.empty(t.shape, dtype=torch.float32, device=t.device)
  w.normal_(generator=generator)
  t.copy_(w * 0.02)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
  return embed[tokens.long()]


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
  x32 = x.float()
  var = torch.mean(x32 * x32, dim=-1, keepdim=True)
  out = x32 * torch.rsqrt(var + eps)
  return (out * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split-half)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
  half = head_dim // 2
  exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
  return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                      device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
  """x (..., S, H, hd), positions (..., S)."""
  hd = x.shape[-1]
  freqs = rope_freqs(hd, theta, x.device)
  angles = positions[..., None].float() * freqs        # (..., S, hd/2)
  cos = torch.cos(angles)[..., None, :]                # (..., S, 1, hd/2)
  sin = torch.sin(angles)[..., None, :]
  x1, x2 = torch.chunk(x.float(), 2, dim=-1)
  out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
  return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Causal attention over the full sequence: the prefill and forward attention
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float, blk: int = 512) -> torch.Tensor:
  """Blockwise causal online-softmax attention in plain PyTorch, never
  materialising (S, S) scores (the reference's `chunked_attention` with
  causal=True and equal q/k blocks of `blk`; any S).

  q (B, Hq, S, d), k/v (B, Hkv, S, d).  This is K7's plain version with
  causal=True.
  """
  return kflash.flash_attention_plain(q, k, v, scale, causal=True, blk=blk)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, blk: int, use_kernel: bool
                     ) -> torch.Tensor:
  """Causal attention over the full sequence: K7 under the `cuda` dispatch
  (`use_kernel`; it masks a ragged last tile itself, so any S), else
  `chunked_attention` in blocks of `blk`."""
  if use_kernel:
    return kops.flash_attention(q, k, v, scale, causal=True)
  return chunked_attention(q, k, v, scale, blk)


# ---------------------------------------------------------------------------
# GQA attention projections and the MLP
# ---------------------------------------------------------------------------

def attention_qkv(params, x: torch.Tensor, positions: torch.Tensor,
                  rope_theta: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """x (B, S, D) -> q (B, H, S, hd), k/v (B, Hkv, S, hd), RoPE applied."""
  q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
  k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
  v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
  q = apply_rope(q, positions, rope_theta)
  k = apply_rope(k, positions, rope_theta)
  return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def attention_out(params, attn: torch.Tensor) -> torch.Tensor:
  """attn (B, H, S, hd) -> (B, S, D)."""
  return torch.einsum("bhsk,hkd->bsd", attn, params["wo"])


def self_attention(params, x: torch.Tensor, positions: torch.Tensor,
                   scale: float, rope_theta: float, blk: int = 512,
                   use_kernel: bool = False) -> torch.Tensor:
  """Causal self-attention of the forward pass (no cache): x (B, S, D) ->
  (B, S, D), routed by `causal_attention`."""
  q, k, v = attention_qkv(params, x, positions, rope_theta)
  return attention_out(params,
                       causal_attention(q, k, v, scale, blk, use_kernel))


def mlp(params, x: torch.Tensor) -> torch.Tensor:
  """SiLU-gated MLP."""
  gate = torch.nn.functional.silu(
      torch.einsum("bsd,df->bsf", x, params["w_gate"]))
  up = torch.einsum("bsd,df->bsf", x, params["w_up"])
  return torch.einsum("bsf,fd->bsd", gate * up, params["w_down"])
