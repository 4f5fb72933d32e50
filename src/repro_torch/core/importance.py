"""Importance weights from attention scores (AQPIM §III-C, Eq. 1).

    w = sum( S[-t:, :], axis=0 )

Port of `repro.core.importance`: the last t valid queries' causal softmax
rows, summed per key, in the same chunked two-pass form.  Leading batch
dimensions (batch, kv head) replace the reference's nested `vmap`.
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_importance_weights(
    q: torch.Tensor,
    k: torch.Tensor,
    scale: float,
    t: int = 32,
    chunk: int = 2048,
    length: Optional[torch.Tensor] = None,
) -> torch.Tensor:
  """Per-token importance weights.

  q, k (..., N, d) prefill queries (post-RoPE) and keys; `length` (...) valid
  lengths (<= N) or None for N.  Returns w (..., N) f32; positions >= length
  get weight 0.
  """
  *lead, n, d = q.shape
  dev = q.device
  if length is None:
    length = torch.full(lead, n, dtype=torch.int32, device=dev)
  length = length.to(torch.int64).expand(lead)[..., None]      # (..., 1)
  q_start = torch.clamp_min(length - t, 0)
  q_idx = q_start + torch.arange(t, device=dev)                # (..., t)
  q_valid = q_idx < length
  gather = torch.clamp(q_idx, 0, n - 1)[..., None].expand(*lead, t, d)
  q_t = torch.gather(q, -2, gather).float()                    # (..., t, d)

  n_chunks = (n + chunk - 1) // chunk
  n_pad = n_chunks * chunk
  k_pad = torch.nn.functional.pad(k, (0, 0, 0, n_pad - n))

  def scores_for_chunk(c):
    k_start = c * chunk
    k_blk = k_pad[..., k_start:k_start + chunk, :].float()
    s = torch.matmul(q_t, k_blk.transpose(-1, -2)) * scale     # (..., t, chunk)
    kpos = k_start + torch.arange(chunk, device=dev)
    causal = kpos[None, :] <= q_idx[..., :, None]
    valid = (kpos < length)[..., None, :] & causal & q_valid[..., :, None]
    return torch.where(valid, s, torch.full_like(s, -torch.inf))

  # pass 1: row max & denom (a row with no valid key yields NaN here and is
  # zeroed in pass 2, as in the reference)
  row_max = torch.full((*lead, t), -torch.inf, device=dev)
  denom = torch.zeros((*lead, t), device=dev)
  for c in range(n_chunks):
    s = scores_for_chunk(c)
    new_max = torch.maximum(row_max, torch.amax(s, dim=-1))
    denom = denom * torch.exp(row_max - new_max) + torch.sum(
        torch.exp(s - new_max[..., None]), dim=-1)
    row_max = new_max
  denom = torch.clamp_min(denom, 1e-30)

  # pass 2: column sums of softmax probabilities
  cols = []
  for c in range(n_chunks):
    s = scores_for_chunk(c)
    p = torch.exp(s - row_max[..., None]) / denom[..., None]
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    cols.append(torch.sum(p, dim=-2))
  w = torch.cat(cols, dim=-1)[..., :n]
  pos = torch.arange(n, device=dev)
  return torch.where(pos < length, w, torch.zeros_like(w))
