"""Transformer layers: RMSNorm, split-half RoPE, chunked causal attention,
GQA projections and the SiLU-gated MLP (port of `repro.models.layers`).

Parameters are mappings of tensors in the reference's layouts (`wq`
(D, H, hd), `wo` (H, hd, D), `w_gate` (D, F), ...).  Compute runs in the
config dtype with f32 softmax and norm statistics, as the reference.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


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
# Chunked causal attention (plain PyTorch flash) -- the prefill attention
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float, blk: int = 512) -> torch.Tensor:
  """Blockwise causal online-softmax attention, never materialising (S, S)
  scores (the prefill attention; the reference's `chunked_attention` with
  causal=True and equal q/k blocks).

  q (B, Hq, S, d), k/v (B, Hkv, S, d); GQA by grouping q as (B, Hkv, g, S, d).
  Key blocks entirely above the causal diagonal of a query block are skipped:
  they would add exactly zero (alpha = 1, p = 0).
  """
  b, hq, sq, d = q.shape
  hkv, sk = k.shape[1], k.shape[2]
  g = hq // hkv
  blk_q = min(blk, sq)
  blk_k = min(blk, sk)
  dev = q.device
  qg = q.reshape(b, hkv, g, sq, d)
  outs = []
  for q0 in range(0, sq, blk_q):
    q_blk = qg[:, :, :, q0:q0 + blk_q].float()
    nq = q_blk.shape[3]
    qpos = q0 + torch.arange(blk_q, device=dev)[:nq]
    acc = torch.zeros((b, hkv, g, nq, d), device=dev)
    m_i = torch.full((b, hkv, g, nq), NEG_INF, device=dev)
    l_i = torch.zeros((b, hkv, g, nq), device=dev)
    for k0 in range(0, sk, blk_k):
      if k0 > q0 + nq - 1:
        break
      k_blk = k[:, :, k0:k0 + blk_k].float()
      v_blk = v[:, :, k0:k0 + blk_k].float()
      s_blk = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, k_blk) * scale
      kpos = k0 + torch.arange(k_blk.shape[2], device=dev)
      mask = kpos[None, :] <= qpos[:, None]
      s_blk = torch.where(mask, s_blk, torch.full_like(s_blk, NEG_INF))
      mu = torch.amax(s_blk, dim=-1)
      m_new = torch.maximum(m_i, mu)
      alpha = torch.exp(m_i - m_new)
      p = torch.exp(s_blk - m_new[..., None])
      l_i = alpha * l_i + torch.sum(p, dim=-1)
      acc = alpha[..., None] * acc + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                  v_blk)
      m_i = m_new
    outs.append(acc / torch.clamp_min(l_i, 1e-30)[..., None])
  out = torch.cat(outs, dim=3)
  return out.reshape(b, hq, sq, d).to(q.dtype)


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


def mlp(params, x: torch.Tensor) -> torch.Tensor:
  """SiLU-gated MLP."""
  gate = torch.nn.functional.silu(
      torch.einsum("bsd,df->bsf", x, params["w_gate"]))
  up = torch.einsum("bsd,df->bsf", x, params["w_up"])
  return torch.einsum("bsf,fd->bsd", gate * up, params["w_down"])
