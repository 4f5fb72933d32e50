"""Importance-weighted k-means clustering (AQPIM §III-C, Eq. (2)).

Port of `repro.core.kmeans`.  Centroids are weighted averages of their
members (Eq. 2); a fixed number of iterations (4, paper §III-B); empty
clusters keep their previous centroid; strided deterministic init.

Every function takes leading batch dimensions (`...`) written out in place
of the reference's `vmap` over heads and subvectors.  All accumulation is
f32.  The assignment runs in plain PyTorch (`assign_clusters`, as the
reference computes it in plain JAX) or, with `use_kernel`, through the CUDA
kernel K6 (`kernels/kmeans_assign.py`); the centroid update in the
reference's one-hot form or, with `use_kernel`, through the CUDA kernel B0
(`kernels/kmeans_update.py`); the PQ policy decides which from its resolved
decode dispatch.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import kmeans_update as _b0
from repro_torch.kernels import ops as kops

DEFAULT_ITERS = 4  # paper §III-B: "just four iterations converge"


def pairwise_sq_dists(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
  """||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2, in that order.

  x (..., N, d), centroids (..., K, d) -> (..., N, K) f32.
  """
  x = x.float()
  centroids = centroids.float()
  x_sq = torch.sum(x * x, dim=-1, keepdim=True)               # (..., N, 1)
  c_sq = torch.sum(centroids * centroids, dim=-1)             # (..., K)
  cross = torch.matmul(x, centroids.transpose(-1, -2))        # (..., N, K)
  return x_sq - 2.0 * cross + c_sq[..., None, :]


def assign_clusters(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
  """Nearest centroid; ties take the first index (as `jnp.argmin`)."""
  return torch.argmin(pairwise_sq_dists(x, centroids), dim=-1).to(torch.int32)


def weighted_update(x: torch.Tensor, w: torch.Tensor, assign: torch.Tensor,
                    centroids: torch.Tensor,
                    use_kernel: bool = False) -> torch.Tensor:
  """One weighted centroid update (Eq. 2): through B0
  (`kernels.ops.kmeans_update`) with `use_kernel`, else in the reference's
  one-hot-matmul form.  x (..., N, d), w (..., N), assign (..., N),
  centroids (..., K, d) -> (..., K, d) f32; empty clusters stay frozen."""
  if use_kernel:
    return kops.kmeans_update(x, w, assign, centroids)
  return _b0.kmeans_update_plain(x, w, assign, centroids)


def steps(use_kernel: bool):
  """(assign, update), the two steps of a k-means iteration: K6
  (`kernels.ops.kmeans_assign`) and B0 with `use_kernel`, else plain
  PyTorch.  `update` is this module's `weighted_update` as it stands when
  `steps` is called, with the choice bound."""
  assign = kops.kmeans_assign if use_kernel else assign_clusters
  return assign, functools.partial(weighted_update, use_kernel=use_kernel)


def init_centroids(x: torch.Tensor, k: int) -> torch.Tensor:
  """Deterministic strided init: every (N//K)-th token (x (..., N, d))."""
  n = x.shape[-2]
  stride = max(n // k, 1)
  idx = (torch.arange(k, device=x.device) * stride) % n
  return x[..., idx, :].float()


def weighted_kmeans(x: torch.Tensor, w: torch.Tensor, k: int,
                    iters: int = DEFAULT_ITERS,
                    mask: Optional[torch.Tensor] = None,
                    use_kernel: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Importance-weighted k-means (each assignment through K6 and each
  update through B0 with `use_kernel`).

  x (..., N, d); w (..., N) non-negative weights; mask (..., N) bool marks
  real rows (padding gets zero weight and never seeds a centroid: masked rows
  collapse onto row 0 for the init).  An all-zero weight row falls back to
  uniform weights.  Returns (centroids (..., k, d) f32, assign (..., N) int32).
  """
  x_init = x
  if mask is not None:
    w = torch.where(mask, w, torch.zeros_like(w))
    x_init = torch.where(mask[..., None], x, x[..., :1, :])
  total = torch.sum(w.float(), dim=-1, keepdim=True)
  w = torch.where(total > 0, w, torch.ones_like(w))

  if use_kernel:
    # K6 and B0 take contiguous rows: lay x out once, not in every call
    x = x.contiguous()
  assign, update = steps(use_kernel)
  centroids = init_centroids(x_init, k)
  for _ in range(iters):
    centroids = update(x, w, assign(x, centroids), centroids)
  return centroids, assign(x, centroids)
