"""Product Quantization codec for activation (KV) compression (AQPIM §III-B).

Port of `repro.core.pq`: a head-dim vector splits into m subvectors of dsub
= d/m, each with its own K-centroid codebook; a token is stored as m
centroid ids.  Functions take leading batch dimensions in place of `vmap`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import kmeans


@dataclasses.dataclass(frozen=True)
class PQConfig:
  """Static PQ hyperparameters (paper Table II/III defaults)."""
  m: int = 32                 # number of subvectors
  k: int = 512                # centroids per subvector codebook
  iters: int = 4              # k-means iterations (fixed; paper §III-B)

  def index_bytes(self) -> int:
    """Bytes per index on target hardware (uint8 if K <= 256 else int16)."""
    return 1 if self.k <= 256 else 2


def split(x: torch.Tensor, m: int) -> torch.Tensor:
  """(..., N, d) -> (..., N, m, dsub)."""
  *lead, n, d = x.shape
  return x.reshape(*lead, n, m, d // m)


def build_codebook(
    x: torch.Tensor,
    weights: torch.Tensor,
    cfg: PQConfig,
    mask: Optional[torch.Tensor] = None,
    init_codebook: Optional[torch.Tensor] = None,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Learn a per-subvector weighted-kmeans codebook and encode x.

  x (..., N, d); weights (..., N); mask (..., N) or None; init_codebook
  (..., m, K, dsub) warm start (windowed clustering) or None; `use_kernel`
  runs every assignment through K6 and every update through B0.
  Returns codebook (..., m, K, dsub) f32 and indices (..., N, m) int32.
  """
  m = cfg.m
  xs = split(x, m).transpose(-2, -3)                 # (..., m, N, dsub)
  w = weights[..., None, :]                          # shared across m
  mk = mask[..., None, :] if mask is not None else None
  if init_codebook is None:
    w = w.expand(xs.shape[:-1])
    mk = mk.expand(xs.shape[:-1]) if mk is not None else None
    codebook, idx = kmeans.weighted_kmeans(xs, w, k=cfg.k, iters=cfg.iters,
                                           mask=mk, use_kernel=use_kernel)
  else:
    if mk is not None:
      w = torch.where(mk, w, torch.zeros_like(w))
    w = w.expand(xs.shape[:-1])
    assign, update = kmeans.steps(use_kernel)
    codebook = init_codebook.float()
    for _ in range(cfg.iters):
      codebook = update(xs, w, assign(xs, codebook), codebook)
    idx = assign(xs, codebook)
  return codebook, idx.transpose(-1, -2)
