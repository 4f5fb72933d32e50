"""PQ-based attention computed directly on compressed KV (AQPIM Fig. 5).

Port of `repro.core.pq_attention`, the plain PyTorch path:

  1. split q into m subvectors
  2. inner-product table  T[j,k] = <q_j, C_key[j,k]>
  3. score lookup         s_n = sum_j T[j, key_idx[n,j]]
  4. softmax over (sink | PQ body | recent window)
  5. values: bucket-sum B[j,k] = sum_{n: val_idx[n,j]=k} p_n, out_j =
     sum_k B[j,k] C_val[j,k] -- or, reassociated, p @ reconstructed values.

Functions take leading batch dimensions (batch, kv head) in place of the
reference's `vmap`; GQA queries arrive as a group (..., g, d).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


def max_or_neg_inf(s: torch.Tensor) -> torch.Tensor:
  """max over the last axis with NEG_INF as the initial value (so an empty
  segment, e.g. a sink-less config, yields NEG_INF)."""
  if s.shape[-1] == 0:
    return torch.full(s.shape[:-1], NEG_INF, dtype=s.dtype, device=s.device)
  return torch.clamp_min(torch.amax(s, dim=-1), NEG_INF)


def inner_product_table(q: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
  """q (..., g, d), codebook (..., m, K, dsub) -> T (..., g, m, K) f32."""
  m, _, dsub = codebook.shape[-3:]
  qs = q.reshape(*q.shape[:-1], m, dsub).float()
  return torch.einsum("...gmd,...mkd->...gmk", qs, codebook.float())


def lookup_scores(table: torch.Tensor, key_indices: torch.Tensor) -> torch.Tensor:
  """T (..., g, m, K), key_indices (..., N, m) -> scores (..., g, N).

  One gather over the flattened (m*K) table axis, indices offset by their
  subvector's page, as in the reference.
  """
  *lead, g, m, k = table.shape
  n = key_indices.shape[-2]
  offs = torch.arange(m, device=key_indices.device) * k
  flat_idx = (key_indices.long() + offs).reshape(*key_indices.shape[:-2],
                                                 n * m)
  flat_idx = flat_idx[..., None, :].expand(*lead, g, n * m)
  gathered = torch.gather(table.reshape(*lead, g, m * k), -1, flat_idx)
  return torch.sum(gathered.reshape(*lead, g, n, m), dim=-1)


def bucket_accumulate(probs: torch.Tensor, value_indices: torch.Tensor,
                      k: int) -> torch.Tensor:
  """probs (..., g, N), value_indices (..., N, m) -> buckets (..., g, m, K).

  Scatter-add of probabilities into per-(subvector, centroid) buckets in the
  reference's one-hot-matmul form.
  """
  onehot = torch.nn.functional.one_hot(value_indices.long(), k).to(
      probs.dtype)                                     # (..., N, m, K)
  return torch.einsum("...gn,...nmk->...gmk", probs, onehot)


def output_from_buckets(buckets: torch.Tensor,
                        value_codebook: torch.Tensor) -> torch.Tensor:
  """buckets (..., g, m, K), codebook (..., m, K, dsub) -> out (..., g, d)."""
  out_sub = torch.einsum("...gmk,...mkd->...gmd", buckets.float(),
                         value_codebook.float())
  return out_sub.reshape(*out_sub.shape[:-2], -1)


def reconstruct_values(value_indices: torch.Tensor,
                       value_codebook: torch.Tensor) -> torch.Tensor:
  """value_indices (..., N, m), codebook (..., m, K, dsub) -> values (..., N, d).

  The dual of the bucket-sum: p @ V_rec equals output_from_buckets(
  bucket_accumulate(p, idx, K), C) with the terms reassociated.
  """
  *lead, n, m = value_indices.shape
  k, dsub = value_codebook.shape[-2:]
  offs = torch.arange(m, device=value_indices.device) * k
  flat = (value_indices.long() + offs).reshape(*lead, n * m, 1)
  cb = value_codebook.float().reshape(*lead, m * k, dsub)
  sub = torch.gather(cb, -2, flat.expand(*lead, n * m, dsub))
  return sub.reshape(*lead, n, m * dsub)


def segment_attention_stats(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask: torch.Tensor,
                            scale: float):
  """One exact segment's flash-decoding partial: q (..., g, d), k/v
  (..., S, d), mask broadcastable to (..., S).

  Returns (normalized out (..., g, d), max (..., g), denom (..., g)), the
  combine contract shared with the kernels.  An all-masked segment yields
  (0, NEG_INF, 0).
  """
  mask = mask[..., None, :]
  s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
  s = torch.where(mask, s, torch.full_like(s, NEG_INF))
  mm = max_or_neg_inf(s)
  p = torch.exp(s - mm[..., None])
  p = torch.where(mask, p, torch.zeros_like(p))
  denom = torch.sum(p, dim=-1)
  out = torch.matmul(p, v.float()) / torch.clamp_min(denom, 1e-30)[..., None]
  return out, mm, denom


class PQAttnSegments(NamedTuple):
  """Compressed context of (batch, kv head) rows (paper §IV-A layout).

  Leading dims (...) on every tensor; masks broadcast against them.
  """
  sink_k: torch.Tensor          # (..., S0, d)
  sink_v: torch.Tensor
  sink_mask: torch.Tensor       # (..., S0) bool
  key_codebook: torch.Tensor    # (..., m, K, dsub) or (..., nW, m, K, dsub)
  value_codebook: torch.Tensor
  key_indices: torch.Tensor     # (..., N, m)
  value_indices: torch.Tensor
  body_mask: torch.Tensor       # (..., N) bool
  recent_k: torch.Tensor        # (..., R, d)
  recent_v: torch.Tensor
  recent_mask: torch.Tensor     # (..., R) bool


def pq_decode_attention(q: torch.Tensor, seg: PQAttnSegments, scale: float,
                        value_mode: str = "bucket") -> torch.Tensor:
  """Single-step decode attention over compressed context, jointly softmaxed.

  q (..., g, d).  Returns (..., g, d) f32.  `value_mode` "bucket" is the
  paper's bucket-sum; "reconstruct" the same sum through decoded value rows.
  Codebooks with a window axis, (..., nW, m, K, dsub) against indices
  (..., N, m), take the page-aware windowed path.
  """
  q32 = q.float()
  windowed = seg.key_codebook.dim() == seg.key_indices.dim() + 2
  if windowed:
    s_body = windowed_lookup_scores(q32, seg.key_codebook,
                                    seg.key_indices) * scale
  else:
    table_k = inner_product_table(q32, seg.key_codebook)
    s_body = lookup_scores(table_k, seg.key_indices) * scale   # (..., g, N)
  body_mask = seg.body_mask[..., None, :]
  s_body = torch.where(body_mask, s_body, torch.full_like(s_body, NEG_INF))

  k_ex = torch.cat([seg.sink_k, seg.recent_k], dim=-2)
  v_ex = torch.cat([seg.sink_v, seg.recent_v], dim=-2)
  mask_ex = torch.cat([seg.sink_mask, seg.recent_mask], dim=-1)[..., None, :]
  s_ex = torch.matmul(q32, k_ex.float().transpose(-1, -2)) * scale
  s_ex = torch.where(mask_ex, s_ex, torch.full_like(s_ex, NEG_INF))

  m_all = torch.maximum(max_or_neg_inf(s_body), max_or_neg_inf(s_ex))
  e_body = torch.exp(s_body - m_all[..., None])
  e_ex = torch.exp(s_ex - m_all[..., None])
  denom = torch.sum(e_body, -1) + torch.sum(e_ex, -1)

  if windowed:
    out_body = windowed_output(e_body, seg.value_indices, seg.value_codebook)
  elif value_mode == "reconstruct":
    vrec = reconstruct_values(seg.value_indices, seg.value_codebook)
    out_body = torch.matmul(e_body, vrec)
  else:
    k_cent = seg.value_codebook.shape[-2]
    buckets = bucket_accumulate(e_body, seg.value_indices, k_cent)
    out_body = output_from_buckets(buckets, seg.value_codebook)
  out_ex = torch.matmul(e_ex, v_ex.float())
  return (out_body + out_ex) / denom[..., None]


def windowed_lookup_scores(q: torch.Tensor, codebooks: torch.Tensor,
                           key_indices: torch.Tensor) -> torch.Tensor:
  """q (..., g, d), codebooks (..., nW, m, K, dsub), key_indices (..., N, m)
  -> (..., g, N); each window's tokens look up their own page."""
  n_w = codebooks.shape[-4]
  *lead, n, m = key_indices.shape
  w = n // n_w
  idx_w = key_indices.reshape(*lead, n_w, w, m)
  table = inner_product_table(q[..., None, :, :], codebooks)  # (..., nW, g, m, K)
  scores = lookup_scores(table, idx_w)                          # (..., nW, g, W)
  return scores.transpose(-2, -3).reshape(*scores.shape[:-3], q.shape[-2], n)


def windowed_output(probs: torch.Tensor, value_indices: torch.Tensor,
                    codebooks: torch.Tensor) -> torch.Tensor:
  """probs (..., g, N), value_indices (..., N, m), codebooks
  (..., nW, m, K, dsub) -> (..., g, d)."""
  n_w, m, k, dsub = codebooks.shape[-4:]
  *lead, g, n = probs.shape
  w = n // n_w
  p_w = probs.reshape(*lead, g, n_w, w).transpose(-2, -3)      # (..., nW, g, W)
  idx_w = value_indices.reshape(*lead, n_w, w, m)
  outs = output_from_buckets(bucket_accumulate(p_w, idx_w, k), codebooks)
  return torch.sum(outs, dim=-3)


def exact_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor, scale: float) -> torch.Tensor:
  """q (..., g, d), k/v (..., N, d), mask broadcastable to (..., N)
  -> (..., g, d) f32 (plain masked softmax attention)."""
  s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
  s = torch.where(mask[..., None, :], s, torch.full_like(s, NEG_INF))
  p = torch.softmax(s, dim=-1)
  return torch.matmul(p, v.float())
