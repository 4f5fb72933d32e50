"""Unified `CachePolicy` API (port of `repro.core.cache_api`, the `exact` and
`pq` policies on the contiguous layout).

Every policy implements:

    init(b, h, d)                                       -> state
    prefill(k, v, weights, lengths)                     -> state
    append_and_attend(state, q, k_new, v_new, lengths)  -> (out, state)

Shapes: k/v (B, H, N, D); q (B, Hq, D) with GQA groups folded into Hq;
`lengths` (B,) int32 per request; `weights` (B, H, N) are the Eq. 1
importance weights (only policies with `needs_weights` receive them).

The decode dispatch (`core.decode_dispatch`) is resolved once, when the
policy is built, against the device its state lives on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import cache_registry, decode_dispatch
from repro_torch.core import kv_cache as kvc


@dataclasses.dataclass(frozen=True)
class CacheSpec:
  """Static geometry + hyperparameters shared by the policies.

  `capacity` is the maximum context (prompt + generated) per request;
  `device` is where the policy's state lives (it decides `auto` dispatch).
  """
  capacity: int
  head_dim: int
  dtype: torch.dtype = torch.bfloat16
  sink: int = 8              # exact sink tokens (paper §IV-A)
  recent: int = 32           # exact recent window (= t of Eq. 1)
  decode_kernel: str = "auto"  # core.decode_dispatch key: torch | cuda | auto
  device: str = "cpu"
  pq: Optional[kvc.PQCacheConfig] = None   # aqpim geometry (policy "pq")

  def __post_init__(self):
    if self.capacity <= 0:
      raise ValueError(f"capacity must be positive, got {self.capacity}")
    if self.sink < 0 or self.recent < 0:
      raise ValueError(
          f"sink/recent must be >= 0, got ({self.sink}, {self.recent})")
    decode_dispatch.validate(self.decode_kernel)

  @staticmethod
  def sm_scale(d: int) -> float:
    return float(d) ** -0.5


class CachePolicy:
  """Base class; subclasses register themselves under a string key."""
  name: str = "base"
  needs_weights: bool = False

  def __init__(self, spec: CacheSpec):
    self.spec = spec
    # resolved once, against the device the state lives on
    self.dispatch = decode_dispatch.resolve(spec.decode_kernel, spec.device)

  @property
  def use_kernel(self) -> bool:
    """Does this policy's decode step run the CUDA kernel?"""
    return self.dispatch.use_kernel

  @property
  def effective_decode_kernel(self) -> str:
    """What runs this policy's decode attention: 'cuda' or 'torch'."""
    return "cuda" if self.use_kernel else "torch"

  def init(self, b: int, h: int, d: int) -> Any:
    raise NotImplementedError

  def prefill(self, k, v, weights=None, lengths=None) -> Any:
    raise NotImplementedError

  def append_and_attend(self, state, q, k_new, v_new, lengths
                        ) -> Tuple[torch.Tensor, Any]:
    raise NotImplementedError

  def __repr__(self) -> str:
    return f"{type(self).__name__}(capacity={self.spec.capacity})"


@cache_registry.register("exact")
class ExactPolicy(CachePolicy):
  """Full-precision KV, dense decode attention (the paper's upper bound).

  With the `cuda` dispatch the step runs the flash-decode kernel (K2).
  """

  def init(self, b: int, h: int, d: int):
    return kvc.exact_cache_init(b, h, self.spec.capacity, d, self.spec.dtype,
                                self.spec.device)

  def prefill(self, k, v, weights=None, lengths=None):
    del weights, lengths  # padding rows are masked at attend time by lengths
    return kvc.exact_cache_prefill(k, v, self.spec.capacity)

  def append_and_attend(self, state, q, k_new, v_new, lengths):
    scale = self.spec.sm_scale(q.shape[-1])
    if self.use_kernel:
      return kvc.exact_cache_append_and_attend_kernel(
          state, q, k_new, v_new, lengths, scale)
    return kvc.exact_cache_append_and_attend(state, q, k_new, v_new, lengths,
                                             scale)


@cache_registry.register("pq")
class PQPolicy(CachePolicy):
  """AQPIM: sink/recent exact, PQ-compressed body, attention on compressed
  data (paper Fig. 3a/5).

  With the `cuda` dispatch the body runs the PQ decode kernel (K1) and the
  exact sink/recent segments combine with it through (max, denom).  The
  kernel takes single-window codebooks only; a multi-window config with the
  `cuda` dispatch raises when the policy is built.
  """
  needs_weights = True

  def __init__(self, spec: CacheSpec):
    super().__init__(spec)
    if spec.pq is None:
      raise ValueError("PQPolicy requires CacheSpec.pq geometry")
    if (spec.pq.sink, spec.pq.recent) != (spec.sink, spec.recent):
      raise ValueError(
          f"CacheSpec sink/recent ({spec.sink},{spec.recent}) must match "
          f"PQCacheConfig ({spec.pq.sink},{spec.pq.recent})")
    if self.use_kernel and spec.pq.n_windows != 1:
      raise ValueError(
          f"the PQ decode kernel takes one codebook window, got "
          f"{spec.pq.n_windows}; use decode kernel 'torch'")
    self.pq_cfg = spec.pq

  def init(self, b: int, h: int, d: int):
    return kvc.pq_cache_init(b, h, d, self.pq_cfg, self.spec.dtype,
                             self.spec.device)

  def prefill(self, k, v, weights=None, lengths=None):
    if weights is None:
      weights = torch.ones(k.shape[:3], dtype=torch.float32, device=k.device)
    return kvc.pq_cache_prefill(k, v, weights, self.pq_cfg, length=lengths)

  def append_and_attend(self, state, q, k_new, v_new, lengths):
    scale = self.spec.sm_scale(q.shape[-1])
    if self.use_kernel:
      return kvc.pq_cache_append_and_attend_kernel(
          state, q, k_new, v_new, lengths, self.pq_cfg, scale)
    return kvc.pq_cache_append_and_attend(
        state, q, k_new, v_new, lengths, self.pq_cfg, scale,
        value_mode=self._plain_value_mode())

  def _plain_value_mode(self) -> str:
    """Size-aware plain value path, as the reference's XLA path: the two
    forms are the same sum reassociated; bucket's one-hot costs O(N*m*K)
    against reconstruction's O(N*d)."""
    if self.pq_cfg.n_windows != 1:
      return "bucket"
    pq = self.pq_cfg.pq
    return "reconstruct" if pq.m * pq.k >= 16 * self.spec.head_dim else \
        "bucket"
