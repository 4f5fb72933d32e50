"""Batched wrappers around the kernels, in the layouts the caches use.

Port of `repro/kernels/ops.py` (dense, block-table-native and packed
decode, the k-means assignment, flash attention; and the k-means update,
which the reference leaves to XLA): each decode wrapper folds (batch, kv
head) into the kernels' BH axis and unfolds the result; `kmeans_assign` and
`kmeans_update` fold every leading dimension into K6's and B0's R axis.  The
block-table-native wrappers pass the (B, nb) tables and (B,) lengths
through as they are: the kernels read row bh's request as bh // H and its
head as bh % H, as the reference's `jnp.repeat(tables, h, axis=0)` plus
`bh % n_heads` do.  The kernel modules decide per device: plain PyTorch on
CPU tensors, the CUDA kernel on CUDA tensors.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import flash_attention as _k7
from repro_torch.kernels import kmeans_assign as _k6
from repro_torch.kernels import kmeans_update as _b0
from repro_torch.kernels import paged_flash_decode as _pfd
from repro_torch.kernels import pq_decode as _pqd


def pq_decode_attention(
    q: torch.Tensor,               # (B, H_kv, g, d)
    key_codebook: torch.Tensor,    # (B, H_kv, m, K, dsub)
    value_codebook: torch.Tensor,  # (B, H_kv, m, K, dsub)
    key_indices: torch.Tensor,     # (B, H_kv, N, m)
    value_indices: torch.Tensor,   # (B, H_kv, N, m)
    length: torch.Tensor,          # (B, H_kv) valid body tokens
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """PQ body attention.  Returns (out (B,H,g,d) f32, max (B,H,g), denom
  (B,H,g))."""
  b, h, g, d = q.shape
  bh = b * h
  m, k_cent, dsub = key_codebook.shape[2:]
  n = key_indices.shape[2]
  out, stats = _pqd.pq_decode_attention(
      q.reshape(bh, g, d).contiguous(),
      key_codebook.reshape(bh, m, k_cent, dsub).contiguous(),
      value_codebook.reshape(bh, m, k_cent, dsub).contiguous(),
      key_indices.reshape(bh, n, m).contiguous(),
      value_indices.reshape(bh, n, m).contiguous(),
      length.reshape(bh).to(torch.int32).contiguous(), scale)
  out = out.reshape(b, h, g, d)
  stats = stats.reshape(b, h, 2, g)
  return out, stats[:, :, 0], stats[:, :, 1]


def pq_decode_attention_paged(
    q: torch.Tensor,               # (B, H_kv, g, d)
    key_codebook: torch.Tensor,    # (B, H_kv, m, K, dsub)
    value_codebook: torch.Tensor,  # (B, H_kv, m, K, dsub)
    key_index_pool: torch.Tensor,  # (P+1, L, H_kv, blk, m) narrow int
    value_index_pool: torch.Tensor,
    tables: torch.Tensor,          # (B, nb) int32 per-slot block tables
    layer: int,
    length: torch.Tensor,          # (B,) valid body tokens
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Block-table-native PQ body attention (no dense index view is built).
  Same return contract as `pq_decode_attention`: (out, max, denom) per
  (B, H, g)."""
  b, h, g, d = q.shape
  bh = b * h
  m, k_cent, dsub = key_codebook.shape[2:]
  out, stats = _pqd.pq_decode_attention_paged(
      q.reshape(bh, g, d).contiguous(),
      key_codebook.reshape(bh, m, k_cent, dsub).contiguous(),
      value_codebook.reshape(bh, m, k_cent, dsub).contiguous(),
      key_index_pool, value_index_pool, tables.to(torch.int32).contiguous(),
      layer, length.to(torch.int32).contiguous(), scale)
  out = out.reshape(b, h, g, d)
  stats = stats.reshape(b, h, 2, g)
  return out, stats[:, :, 0], stats[:, :, 1]


def flash_decode(
    q: torch.Tensor,        # (B, H_kv, g, d)
    k: torch.Tensor,        # (B, H_kv, N, d)
    v: torch.Tensor,        # (B, H_kv, N, d)
    length: torch.Tensor,   # (B,) valid tokens per request
    scale: float,
) -> torch.Tensor:
  """Dense-storage flash decode (exact policy, contiguous layout)."""
  b, h, g, d = q.shape
  n = k.shape[2]
  length = length.to(torch.int32).repeat_interleave(h).contiguous()
  out = _pfd.flash_decode(
      q.reshape(b * h, g, d).contiguous(),
      k.reshape(b * h, n, d).contiguous(), v.reshape(b * h, n, d).contiguous(),
      length, scale)
  return out.reshape(b, h, g, d)


def paged_flash_decode(
    q: torch.Tensor,        # (B, H_kv, g, d)
    k_pool: torch.Tensor,   # (P+1, L, H_kv, blk, d)
    v_pool: torch.Tensor,
    tables: torch.Tensor,   # (B, nb) int32
    layer: int,
    length: torch.Tensor,   # (B,) valid tokens per request
    scale: float,
) -> torch.Tensor:
  """Block-table-native flash decode over pooled K/V (exact policy)."""
  b, h, g, d = q.shape
  out = _pfd.paged_flash_decode(
      q.reshape(b * h, g, d).contiguous(), k_pool, v_pool,
      tables.to(torch.int32).contiguous(), layer,
      length.to(torch.int32).contiguous(), scale)
  return out.reshape(b, h, g, d)


def packed_paged_flash_decode(
    q: torch.Tensor,        # (B, H_kv, g, d)
    k_pack: torch.Tensor,   # (P+1, L, H_kv, blk, d*bits/8) uint8
    k_scale: torch.Tensor,  # (P+1, L, H_kv, blk, G) f16
    k_min: torch.Tensor,
    v_pack: torch.Tensor,
    v_scale: torch.Tensor,
    v_min: torch.Tensor,
    tables: torch.Tensor,   # (B, nb) int32
    layer: int,
    length: torch.Tensor,   # (B,) valid tokens per request
    scale: float,
    bits: int,
) -> torch.Tensor:
  """Block-table-native flash decode over sub-byte packed pooled K/V (exact
  policy with `kv_resident_codec` q4/q5/q8): mapped pages are decoded on
  load, never densified in device memory."""
  b, h, g, d = q.shape
  out = _pfd.packed_paged_flash_decode(
      q.reshape(b * h, g, d).contiguous(), k_pack, k_scale, k_min, v_pack,
      v_scale, v_min, tables.to(torch.int32).contiguous(), layer,
      length.to(torch.int32).contiguous(), scale, bits)
  return out.reshape(b, h, g, d)


def kmeans_assign(
    x: torch.Tensor,           # (..., N, dsub)
    centroids: torch.Tensor,   # (..., K, dsub)
) -> torch.Tensor:
  """Nearest-centroid ids (..., N) int32 through K6, one launch for all
  leading dims.  K6 drops ||x||^2 from the distance, so a near-tie may
  resolve otherwise than `core.kmeans.assign_clusters` (ROADMAP C6)."""
  n, dsub = x.shape[-2:]
  k = centroids.shape[-2]
  ids = _k6.kmeans_assign(x.reshape(-1, n, dsub).contiguous(),
                          centroids.reshape(-1, k, dsub).contiguous())
  return ids.reshape(x.shape[:-1])


def kmeans_update(
    x: torch.Tensor,           # (..., N, dsub)
    w: torch.Tensor,           # (..., N)
    assign: torch.Tensor,      # (..., N)
    centroids: torch.Tensor,   # (..., K, dsub)
) -> torch.Tensor:
  """One weighted centroid update (..., K, dsub) f32 through B0, one launch
  for all leading dims; on the card its sums run in another order than the
  one-hot matmul's (`kmeans_update.REL_TOL`), the same in every call."""
  n, dsub = x.shape[-2:]
  k = centroids.shape[-2]
  new = _b0.kmeans_update(
      x.reshape(-1, n, dsub).contiguous(),
      w.float().expand(x.shape[:-1]).reshape(-1, n).contiguous(),
      assign.to(torch.int32).reshape(-1, n).contiguous(),
      centroids.float().reshape(-1, k, dsub).contiguous())
  return new.reshape(centroids.shape)


def flash_attention(
    q: torch.Tensor,        # (B, Hq, N, d)
    k: torch.Tensor,        # (B, Hkv, N, d)
    v: torch.Tensor,        # (B, Hkv, N, d)
    scale: float,
    causal: bool = True,
) -> torch.Tensor:
  """Blockwise flash attention through K7 (any N; GQA by h // (Hq/Hkv)).
  Returns (B, Hq, N, d) in q's dtype."""
  return _k7.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             scale, causal)


def combine_attention_segments(outs, maxes, denoms) -> torch.Tensor:
  """Exact flash-decoding combine of per-segment partial attentions.

  Each segment supplies a normalised output plus its (max, denom); the
  combine is the softmax over the union of segments.  Shapes: out
  (..., g, d); max/denom (..., g).
  """
  m_all = functools.reduce(torch.maximum, maxes)
  num = None
  den = None
  for o, mm, l in zip(outs, maxes, denoms):
    w = l * torch.exp(mm - m_all)
    term = o * w[..., None]
    num = term if num is None else num + term
    den = w if den is None else den + w
  return num / torch.clamp_min(den, 1e-30)[..., None]
