"""Baseline KV-cache methods the paper compares against (§IV-A/B, Fig. 10).

Port of `repro.core.baselines`, batched: every function takes leading dims
(batch, kv head) written out in place of the reference's per-head `vmap`;
token-axis tensors are (..., N, d), query groups (..., g, d), per-row
scalars (lengths) broadcast against the leading dims.

- SKVQ-like   : group-wise uniform quantization with channel reordering
                (asymmetric per-(token, channel-group); quantize-dequantize,
                then exact attention).
- SnapKV-like : eviction; sinks and recents kept, plus the top-`keep` body
                tokens by observed attention importance.
- StreamingLLM: static sink + sliding window, everything else evicted.
- PQCache-like: PQ used only to select the top-`keep` tokens (approximate
                inner-product search); exact attention over the selection.

Selections sort with a stable order, as `jnp.argsort`, so ties resolve as
in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import pq, pq_attention

NEG_INF = -1e30


class UniformQuantized(NamedTuple):
  q: torch.Tensor        # (..., N, d) uint8 (int32 above 8 bits)
  scale: torch.Tensor    # (..., N, groups) f32
  zero: torch.Tensor     # (..., N, groups) f32
  perm: torch.Tensor     # (..., d) channel reorder
  bits: int


def _permute(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
  """x (..., N, d) with its channels taken in the order perm (..., d)."""
  return torch.gather(x, -1, perm[..., None, :].expand(x.shape))


def channel_reorder_by_range(x: torch.Tensor) -> torch.Tensor:
  """SKVQ's channel order: channels sorted by dynamic range over the tokens,
  so similar ranges share a quantization group.  x (..., N, d) -> (..., d)."""
  rng = torch.amax(x, dim=-2) - torch.amin(x, dim=-2)
  return torch.argsort(rng, dim=-1, stable=True)


def uniform_quantize(x: torch.Tensor, bits: int, group: int,
                     perm: torch.Tensor) -> UniformQuantized:
  """Asymmetric per-(token, channel-group) uniform quantization."""
  *lead, n, d = x.shape
  xg = _permute(x, perm).float().reshape(*lead, n, d // group, group)
  lo = torch.amin(xg, dim=-1)
  hi = torch.amax(xg, dim=-1)
  qmax = float(2 ** bits - 1)
  scale = torch.clamp_min(hi - lo, 1e-8) / qmax
  q = torch.clamp(torch.round((xg - lo[..., None]) / scale[..., None]), 0,
                  qmax)
  return UniformQuantized(
      q=q.reshape(*lead, n, d).to(torch.uint8 if bits <= 8 else torch.int32),
      scale=scale, zero=lo, perm=perm, bits=bits)


def uniform_dequantize(uq: UniformQuantized, group: int) -> torch.Tensor:
  *lead, n, d = uq.q.shape
  xg = uq.q.float().reshape(*lead, n, d // group, group)
  xp = (xg * uq.scale[..., None] + uq.zero[..., None]).reshape(*lead, n, d)
  return _permute(xp, torch.argsort(uq.perm, dim=-1, stable=True))


def skvq_decode_attention(q, k, v, mask, scale: float, bits: int = 4,
                          group: int = 32) -> torch.Tensor:
  """Quantize-dequantize K and V, then exact attention (GPUs must upcast,
  §IV-E).  q (..., g, d), k/v (..., N, d), mask (..., N)."""
  k_hat = uniform_dequantize(
      uniform_quantize(k, bits, group, channel_reorder_by_range(k)), group)
  v_hat = uniform_dequantize(
      uniform_quantize(v, bits, group, channel_reorder_by_range(v)), group)
  return pq_attention.exact_decode_attention(q, k_hat, v_hat, mask, scale)


def _keep_mask(score: torch.Tensor, keep: int) -> torch.Tensor:
  """Bool mask (..., N) of the `keep` highest scores, ties to the lower
  index (the reference's `argsort(-score)[:keep]`)."""
  top = torch.argsort(-score, dim=-1, stable=True)[..., :keep]
  return torch.zeros_like(score, dtype=torch.bool).scatter(-1, top, True)


def snapkv_select(weights: torch.Tensor, keep: int, sink: int, recent: int,
                  length) -> torch.Tensor:
  """Token keep-mask (..., N): sinks and recents always kept, plus the
  top-`keep` body tokens by weight.  weights (..., N); length broadcasts
  against the leading dims."""
  n = weights.shape[-1]
  pos = torch.arange(n, device=weights.device)
  length = torch.as_tensor(length, device=weights.device)[..., None]
  valid = pos < length
  always = (pos < sink) | ((pos >= length - recent) & valid)
  body_w = torch.where(always | ~valid,
                       torch.full_like(weights, -float("inf")), weights)
  return (_keep_mask(body_w, keep) & valid) | (always & valid)


def snapkv_decode_attention(q, k, v, weights, length, scale: float,
                            keep: int, sink: int = 8, recent: int = 32
                            ) -> torch.Tensor:
  mask = snapkv_select(weights, keep, sink, recent, length)
  return pq_attention.exact_decode_attention(q, k, v, mask, scale)


def streaming_llm_decode_attention(q, k, v, length, scale: float,
                                   sink: int = 8, window: int = 512
                                   ) -> torch.Tensor:
  pos = torch.arange(k.shape[-2], device=k.device)
  length = torch.as_tensor(length, device=k.device)[..., None]
  mask = ((pos < sink) | (pos >= length - window)) & (pos < length)
  return pq_attention.exact_decode_attention(q, k, v, mask, scale)


def pqcache_decode_attention(q, k, v, mask, scale: float, cfg: pq.PQConfig,
                             keep: int, use_kernel: bool = False
                             ) -> Tuple[torch.Tensor, dict]:
  """Approximate MIPS through PQ scores, then exact attention over the
  top-`keep` tokens.  The index is a codebook built on the valid keys
  (every assignment through K6 and every update through B0 with
  `use_kernel`).

  Returns (out (..., g, d), traffic): the exact-KV bytes that would cross
  PCIe per (batch, kv head) in the real system, and the index's bytes.
  """
  d = q.shape[-1]
  n = k.shape[-2]
  w = torch.ones(k.shape[:-1], dtype=torch.float32, device=k.device)
  codebook, idx = pq.build_codebook(k, w, cfg, mask=mask,
                                    use_kernel=use_kernel)
  table = pq_attention.inner_product_table(q, codebook)
  approx = pq_attention.lookup_scores(table, idx)              # (..., g, N)
  approx = torch.where(mask[..., None, :], approx,
                       torch.full_like(approx, NEG_INF))
  score = torch.amax(approx, dim=-2)                 # group max (GQA union)
  sel = _keep_mask(score, keep) & mask
  out = pq_attention.exact_decode_attention(q, k, v, sel, scale)
  traffic = dict(
      fetched_bytes=int(keep) * d * 2 * 2,    # k+v bf16 over PCIe per step
      index_bytes=n * cfg.m * cfg.index_bytes(),
  )
  return out, traffic
