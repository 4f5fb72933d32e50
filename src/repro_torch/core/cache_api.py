"""Unified `CachePolicy` API (port of `repro.core.cache_api`: the `exact`
policy with its packed resident store, the AQPIM `pq` policy, and the four
baselines of the paper's Fig. 10, `streamingllm`, `skvq`, `snapkv` and
`pqcache`).

Every policy implements:

    init(b, h, d)                                       -> state
    prefill(k, v, weights, lengths)                     -> state
    append_and_attend(state, q, k_new, v_new, lengths)  -> (out, state)
    bytes(b, h, d)                                      -> dict

and, as a codec over a paged layout (`core.cache_layout.PagedLayout`):
`paged_axes`, `paged_capacity`, `token_extent`, `pinned_tokens`,
`dead_below`, and (where `block_native`) `append_and_attend_paged`.

Shapes: k/v (B, H, N, D); q (B, Hq, D) with GQA groups folded into Hq;
`lengths` (B,) int32 per request; `weights` (B, H, N) are the Eq. 1
importance weights (only policies with `needs_weights` receive them).

The decode dispatch (`core.decode_dispatch`) is resolved once, when the
policy is built, against the device its state lives on.  The baselines have
no decode kernel (their decode is plain PyTorch on any dispatch); under the
`cuda` dispatch their prefill attention runs K7 like every policy's, and
`pqcache`'s per-step index build runs K6.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import baselines, cache_registry, decode_dispatch
from repro_torch.core import kv_cache as kvc
from repro_torch.core import pq as pqlib
from repro_torch.core import pq_attention
from repro_torch.kernels import packing

# the reference's spill codecs (`repro.core.tiers.SPILL_CODECS`); the tiered
# layout that uses them is not ported yet (ROADMAP A9), so the field is
# validated and carried, nothing more
SPILL_CODECS = ("raw", "int8", "q4", "q5", "q8")


def _fit_m(m: int, d: int) -> int:
  while m > 1 and d % m != 0:
    m //= 2
  return max(m, 1)


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
  window: int = 512          # streamingllm sliding window
  bits: int = 4              # skvq uniform-quant bits
  group: int = 32            # skvq channel-group size
  keep_frac: float = 0.25    # snapkv / pqcache kept-token fraction
  block: int = 0             # paged-layout token-block size (0 = contiguous)
  spill_codec: str = "raw"   # tiered-layout spill codec (SPILL_CODECS; the
                             # tiered layout is ROADMAP A9)
  kv_resident_codec: str = "none"  # exact-policy resident store: none keeps
                             # dense floats; q4/q5/q8 store packed codes +
                             # f16 headers (kernels/packing.py).  Other
                             # policies ignore it.
  decode_kernel: str = "auto"  # core.decode_dispatch key: torch | cuda | auto
  device: str = "cpu"
  pq: Optional[kvc.PQCacheConfig] = None   # aqpim geometry (policy "pq")
  pq_select: Optional[pqlib.PQConfig] = None  # pqcache ANN-index codec
  scale: Optional[float] = None            # softmax scale; None -> d^-0.5

  def __post_init__(self):
    if self.capacity <= 0:
      raise ValueError(f"capacity must be positive, got {self.capacity}")
    if self.sink < 0 or self.recent < 0:
      raise ValueError(
          f"sink/recent must be >= 0, got ({self.sink}, {self.recent})")
    if not 0.0 < self.keep_frac <= 1.0:
      raise ValueError(f"keep_frac must be in (0, 1], got {self.keep_frac}")
    if self.block < 0:
      raise ValueError(f"block must be >= 0, got {self.block}")
    if self.spill_codec not in SPILL_CODECS:
      raise ValueError(
          f"spill_codec must be one of {tuple(sorted(SPILL_CODECS))}, "
          f"got {self.spill_codec!r}")
    if self.kv_resident_codec not in packing.RESIDENT_CODECS:
      raise ValueError(
          f"kv_resident_codec must be one of "
          f"{tuple(packing.RESIDENT_CODECS)}, got "
          f"{self.kv_resident_codec!r}")
    if not 0 < self.window <= self.capacity:
      raise ValueError(
          f"window must be in (0, capacity={self.capacity}], got "
          f"{self.window}")
    decode_dispatch.validate(self.decode_kernel)
    if self.block and self.capacity % self.block:
      raise ValueError(
          f"capacity {self.capacity} not divisible by block size "
          f"{self.block} (paged layouts need whole token blocks)")
    if (self.block and self.pq is not None
        and self.pq.body_capacity % self.block):
      raise ValueError(
          f"pq body_capacity {self.pq.body_capacity} not divisible by "
          f"block size {self.block}")

  @property
  def keep(self) -> int:
    return max(int(self.capacity * self.keep_frac), 1)

  def sm_scale(self, d: int) -> float:
    return self.scale if self.scale is not None else float(d) ** -0.5


class WeightedLayerCache(NamedTuple):
  """Exact KV plus per-token importance (snapkv's observation window)."""
  k: torch.Tensor               # (B, H, N, D)
  v: torch.Tensor
  w: torch.Tensor               # (B, H, N) f32


# Sentinel for `CachePolicy.paged_axes`: the leaf has no token axis and stays
# resident per slot (never paged).
RESIDENT = -1


class CachePolicy:
  """Base class; subclasses register themselves under a string key.

  Beyond the storage methods, a policy is a codec over a layout: it says
  which leaves of its state carry a token axis (`paged_axes`) and how many
  paged tokens a cached length occupies (`token_extent`), so `PagedLayout`
  can page any policy's state without knowing its internals.
  """
  name: str = "base"
  needs_weights: bool = False
  #: does the policy have a decode kernel?  Without one it decodes plain
  #: PyTorch whatever the dispatch says
  kernel_decode: bool = False

  def __init__(self, spec: CacheSpec):
    self.spec = spec
    # resolved once, against the device the state lives on
    self.dispatch = decode_dispatch.resolve(spec.decode_kernel, spec.device)

  @property
  def use_kernel(self) -> bool:
    """Does this policy's decode step run the CUDA kernel?"""
    return self.dispatch.use_kernel and self.kernel_decode

  @property
  def effective_decode_kernel(self) -> str:
    """What runs this policy's decode attention: 'cuda' or 'torch'."""
    return "cuda" if self.use_kernel else "torch"

  @property
  def block_native(self) -> bool:
    """Can the paged decode step read pool storage in place (no dense
    gather)?  True exactly when the policy runs its kernel; pooled layouts
    pick the block-native program or the dense gather->decode->scatter one
    from this."""
    return False

  def init(self, b: int, h: int, d: int) -> Any:
    raise NotImplementedError

  def prefill(self, k, v, weights=None, lengths=None) -> Any:
    raise NotImplementedError

  def append_and_attend(self, state, q, k_new, v_new, lengths
                        ) -> Tuple[torch.Tensor, Any]:
    raise NotImplementedError

  def bytes(self, b: int, h: int, d: int) -> dict:
    raise NotImplementedError

  # -- paged-layout codec surface -------------------------------------------
  def paged_axes(self):
    """NamedTuple matching one batched state (leading dim B): per leaf, the
    token-axis index, or RESIDENT for fixed-size leaves (codebooks, rings)."""
    raise NotImplementedError(
        f"{type(self).__name__} does not describe a paged layout")

  def paged_capacity(self) -> int:
    """Size of the paged token axis (the dense buffer the codec attends on)."""
    return self.spec.capacity

  def token_extent(self, length: int) -> int:
    """Paged tokens that must be resident when `length` tokens are cached."""
    return min(length, self.paged_capacity())

  def pinned_tokens(self) -> int:
    """Leading paged tokens that may never be reclaimed (attention sinks)."""
    return 0

  def dead_below(self, length: int) -> int:
    """Paged-token positions < this are evicted by the policy's own masking
    and may be reclaimed (ring-reuse); 0 means nothing is reclaimable."""
    del length
    return 0

  def spill_codecs(self):
    """Spill-codec key per state leaf (paged_axes order): how each paged
    buffer would cross to the host tier (ROADMAP A9).  Default: verbatim."""
    axes = self.paged_axes()
    return type(axes)(*(["raw"] * len(axes)))

  def append_and_attend_paged(self, resident_leaves, pool_leaves, layer: int,
                              tables, q, k_new, v_new, lengths):
    """Block-table-native decode step over pooled storage.

    `resident_leaves` / `pool_leaves` are the state's leaves (paged_axes
    order) with the other kind's entries None: resident leaves carry this
    layer's per-slot state (B, ...), pool leaves the physical pools
    (P+1, L, ..., block, ...) shared across layers, written in place;
    `layer` is a Python int, `tables` the (B, nb) int32 block tables.
    Returns (out (B, Hq, D), resident_leaves, pool_leaves) with the same None
    pattern.  Only policies with `block_native` implement this.
    """
    raise NotImplementedError(
        f"{type(self).__name__} has no block-native decode step")

  def __repr__(self) -> str:
    return f"{type(self).__name__}(capacity={self.spec.capacity})"


class _ExactStorePolicy(CachePolicy):
  """Shared store and append for the policies that keep exact KV.

  Subclasses override `_attend(q, k, v, w, length)`, batched over (batch,
  kv head): q (B, H, g, d), k/v (B, H, N, d), w (B, H, N) f32 or None,
  `length` (B, 1) the cached tokens before the one just inserted (valid
  positions are < length + 1).  Returns (B, H, g, d) f32.
  """
  tracks_weights = False

  def init(self, b: int, h: int, d: int):
    base = kvc.exact_cache_init(b, h, self.spec.capacity, d, self.spec.dtype,
                                self.spec.device)
    if not self.tracks_weights:
      return base
    w = torch.zeros((b, h, self.spec.capacity), dtype=torch.float32,
                    device=self.spec.device)
    return WeightedLayerCache(k=base.k, v=base.v, w=w)

  def prefill(self, k, v, weights=None, lengths=None):
    del lengths  # padding rows are masked at attend time by lengths
    base = kvc.exact_cache_prefill(k, v, self.spec.capacity)
    if not self.tracks_weights:
      return base
    b, h, n, _ = k.shape
    w = (weights if weights is not None
         else torch.zeros((b, h, n), device=k.device))
    w = torch.nn.functional.pad(w.float(), (0, self.spec.capacity - n))
    return WeightedLayerCache(k=base.k, v=base.v, w=w)

  def append_and_attend(self, state, q, k_new, v_new, lengths):
    b, hq, d = q.shape
    h = state.k.shape[1]
    lens = kvc.as_lengths(lengths, b, q.device)
    k_c, v_c = kvc.exact_insert_one(state.k, state.v, k_new, v_new, lens)
    w_c = None
    if self.tracks_weights:
      # generated tokens get +inf importance: real SnapKV compresses only the
      # prompt, so post-prefill tokens outrank every observed prompt weight
      # in the top-keep selection once they age out of `recent`
      pos = torch.arange(state.w.shape[-1], device=q.device)
      w_c = torch.where(pos == lens.long()[:, None, None],
                        torch.full_like(state.w, float("inf")), state.w)
    out = self._attend(q.reshape(b, h, hq // h, d), k_c, v_c, w_c,
                       lens.long()[:, None])
    if self.tracks_weights:
      return out.reshape(b, hq, d), WeightedLayerCache(k=k_c, v=v_c, w=w_c)
    return out.reshape(b, hq, d), kvc.ExactLayerCache(k=k_c, v=v_c)

  def _attend(self, q, k, v, w, length) -> torch.Tensor:
    raise NotImplementedError

  @staticmethod
  def _valid_mask(n: int, length: torch.Tensor) -> torch.Tensor:
    """(B, 1, N): positions < length + 1."""
    return torch.arange(n, device=length.device) < (length + 1)[..., None]

  def paged_axes(self):
    # k/v (B, H, N, D) and w (B, H, N): token axis 2 on every leaf
    if self.tracks_weights:
      return WeightedLayerCache(k=2, v=2, w=2)
    return kvc.ExactLayerCache(k=2, v=2)

  def spill_codecs(self):
    # importance weights drive the top-k selection and always spill raw
    c = self.spec.spill_codec
    if self.tracks_weights:
      return WeightedLayerCache(k=c, v=c, w="raw")
    return kvc.ExactLayerCache(k=c, v=c)

  def _bytes(self, per_head: int, b: int, h: int, d: int, **extra) -> dict:
    """The reference's byte accounting: `per_head` bytes of store per (batch,
    kv head) against the full bf16 exact store."""
    exact = self.spec.capacity * d * 2 * 2
    return dict(per_head_bytes=per_head, total_bytes=per_head * b * h,
                equivalent_exact_bytes=exact * b * h,
                reduction_ratio=exact / per_head, **extra)


@cache_registry.register("exact")
class ExactPolicy(_ExactStorePolicy):
  """Full-precision KV, dense decode attention (the paper's upper bound).

  With the `cuda` dispatch the step runs the flash-decode kernel (K2), and
  on the paged layout K4.  With `CacheSpec.kv_resident_codec` set to
  q4/q5/q8, construction yields a `PackedExactPolicy`: the same registry
  key, a packed resident store.
  """
  kernel_decode = True

  def __new__(cls, spec: CacheSpec):
    # the resident codec is a storage format, not another algorithm: "exact"
    # stays the one registry key and the spec picks the store
    if cls is ExactPolicy and spec.kv_resident_codec != "none":
      return super().__new__(PackedExactPolicy)
    return super().__new__(cls)

  @property
  def block_native(self) -> bool:
    return self.use_kernel

  def append_and_attend(self, state, q, k_new, v_new, lengths):
    scale = self.spec.sm_scale(q.shape[-1])
    if self.use_kernel:
      return kvc.exact_cache_append_and_attend_kernel(
          state, q, k_new, v_new, lengths, scale)
    return kvc.exact_cache_append_and_attend(state, q, k_new, v_new, lengths,
                                             scale)

  def bytes(self, b: int, h: int, d: int) -> dict:
    return self._bytes(self.spec.capacity * d * 2 * 2, b, h, d)

  def append_and_attend_paged(self, resident_leaves, pool_leaves, layer,
                              tables, q, k_new, v_new, lengths):
    k_pool, v_pool = pool_leaves
    out, k_pool, v_pool = kvc.exact_cache_paged_step(
        k_pool, v_pool, layer, tables, q, k_new, v_new, lengths,
        self.spec.sm_scale(q.shape[-1]))
    return out, list(resident_leaves), [k_pool, v_pool]


class PackedExactPolicy(ExactPolicy):
  """Exact attention over a sub-byte packed resident store (q4/q5/q8).

  State is `kv_cache.PackedExactLayerCache`: split-half nibble codes plus
  per-group f16 scale/min rows (kernels/packing.py block format), about
  0.19x the fp32 store at q4.  With the `cuda` dispatch the contiguous step
  dequantizes the store through K8 and attends through K2, and the paged
  step is block-native through K5 (pages decoded on load); the plain path
  dequantizes with the same formula.

  Built by `ExactPolicy.__new__` when `spec.kv_resident_codec` is not
  "none"; never registered under a key of its own.
  """
  # chunked suffix prefill writes dense K/V rows only, so prefix blocks are
  # not shareable
  prefix_shareable = False

  def __init__(self, spec: CacheSpec):
    super().__init__(spec)
    self.bits = packing.RESIDENT_CODECS[spec.kv_resident_codec]

  def init(self, b: int, h: int, d: int):
    return kvc.packed_exact_cache_init(b, h, self.spec.capacity, d,
                                       self.bits, self.spec.device)

  def prefill(self, k, v, weights=None, lengths=None):
    del weights, lengths  # padding rows are masked at attend time
    return kvc.packed_exact_cache_prefill(k, v, self.spec.capacity,
                                          self.bits)

  def append_and_attend(self, state, q, k_new, v_new, lengths):
    return kvc.packed_exact_cache_append_and_attend(
        state, q, k_new, v_new, lengths, self.spec.sm_scale(q.shape[-1]),
        bits=self.bits, use_kernel=self.use_kernel)

  def append_and_attend_paged(self, resident_leaves, pool_leaves, layer,
                              tables, q, k_new, v_new, lengths):
    out, pools = kvc.packed_exact_cache_paged_step(
        pool_leaves, layer, tables, q, k_new, v_new, lengths,
        self.spec.sm_scale(q.shape[-1]), bits=self.bits)
    return out, list(resident_leaves), pools

  def paged_axes(self):
    return kvc.PackedExactLayerCache(k_pack=2, k_scale=2, k_min=2,
                                     v_pack=2, v_scale=2, v_min=2)

  def spill_codecs(self):
    # the tiered layout (ROADMAP A9) would move packed pages verbatim:
    # re-quantizing codes would corrupt them
    return kvc.PackedExactLayerCache(k_pack="raw", k_scale="raw",
                                     k_min="raw", v_pack="raw",
                                     v_scale="raw", v_min="raw")

  def bytes(self, b: int, h: int, d: int) -> dict:
    group = packing.group_size(d)
    # codes + f16 scale/min headers, k and v
    per_tok = packing.packed_width(d, self.bits) + (d // group) * 4
    return self._bytes(self.spec.capacity * per_tok * 2, b, h, d)


@cache_registry.register("streamingllm")
class StreamingLLMPolicy(_ExactStorePolicy):
  """Static sink + sliding window; everything else evicted (masked).  On
  the paged layout the blocks that age out of the window are freed."""

  def _attend(self, q, k, v, w, length):
    return baselines.streaming_llm_decode_attention(
        q, k, v, length + 1, self.spec.sm_scale(q.shape[-1]),
        sink=self.spec.sink, window=self.spec.window)

  def pinned_tokens(self) -> int:
    return self.spec.sink

  def dead_below(self, length: int) -> int:
    # tokens below length - window are masked out for good: their blocks
    # can be recycled (the paged layout's ring reuse)
    return max(length - self.spec.window, 0)

  def bytes(self, b: int, h: int, d: int) -> dict:
    kept = min(self.spec.sink + self.spec.window, self.spec.capacity)
    return self._bytes(kept * d * 2 * 2, b, h, d)


@cache_registry.register("skvq")
class SKVQPolicy(_ExactStorePolicy):
  """Sliding-window uniform quantization with channel reordering.

  Storage is modeled (`bytes`); compute follows §IV-E: GPUs must upcast, so
  the step quantize-dequantizes the whole valid context.
  """

  def _attend(self, q, k, v, w, length):
    mask = self._valid_mask(k.shape[-2], length)
    # zero masked rows so stale rows never skew the channel-range reorder
    k_m = torch.where(mask[..., None], k, torch.zeros_like(k))
    v_m = torch.where(mask[..., None], v, torch.zeros_like(v))
    return baselines.skvq_decode_attention(
        q, k_m, v_m, mask, self.spec.sm_scale(q.shape[-1]),
        bits=self.spec.bits, group=min(self.spec.group, k.shape[-1]))

  def bytes(self, b: int, h: int, d: int) -> dict:
    g = min(self.spec.group, d)
    per_tok = d * self.spec.bits / 8 + (d // g) * 4   # codes + scale/zero
    return self._bytes(int(self.spec.capacity * per_tok) * 2, b, h, d)


@cache_registry.register("snapkv")
class SnapKVPolicy(_ExactStorePolicy):
  """Importance top-k eviction: sinks + recents + the top-`keep` body
  tokens.  The prompt body competes for the budget by its observed Eq. 1
  importance; generated tokens (weighted +inf at append) are never evicted
  in favour of prompt tokens."""
  needs_weights = True
  tracks_weights = True

  def _attend(self, q, k, v, w, length):
    mask = baselines.snapkv_select(
        w, keep=self.spec.keep, sink=self.spec.sink, recent=self.spec.recent,
        length=length + 1)
    return pq_attention.exact_decode_attention(
        q, k, v, mask, self.spec.sm_scale(q.shape[-1]))

  def bytes(self, b: int, h: int, d: int) -> dict:
    kept = min(self.spec.sink + self.spec.recent + self.spec.keep,
               self.spec.capacity)
    return self._bytes(kept * d * 2 * 2, b, h, d)


@cache_registry.register("pqcache")
class PQCachePolicy(_ExactStorePolicy):
  """PQ as an ANN index to select the top-`keep` tokens, exact KV for the
  selection; the cost AQPIM removes is the per-step exact-KV fetch over
  PCIe (`bytes()['fetched_bytes_per_step']`).

  As in the reference this models selection quality and traffic, not wall
  clock: the index is rebuilt from scratch every step (through K6 and B0
  under the `cuda` dispatch), where the real PQCache builds it once and
  appends.
  """

  def _select_cfg(self, d: int) -> pqlib.PQConfig:
    if self.spec.pq_select is not None:
      return self.spec.pq_select
    # the reference's Fig. 10 operating point: a strong baseline
    return pqlib.PQConfig(m=_fit_m(16, d), k=128, iters=4)

  def _attend(self, q, k, v, w, length):
    mask = self._valid_mask(k.shape[-2], length).expand(k.shape[:-1])
    out, _ = baselines.pqcache_decode_attention(
        q, k, v, mask, self.spec.sm_scale(q.shape[-1]),
        self._select_cfg(k.shape[-1]), keep=self.spec.keep,
        use_kernel=self.dispatch.use_kernel)
    return out

  def bytes(self, b: int, h: int, d: int) -> dict:
    cfg = self._select_cfg(d)
    # on-accelerator footprint: the index; the exact KV is fetched per step
    fetched = self.spec.keep * d * 2 * 2 * b * h
    return self._bytes(self.spec.capacity * cfg.m * cfg.index_bytes() * 2,
                       b, h, d, fetched_bytes_per_step=fetched)


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
  kernel_decode = True

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

  @property
  def block_native(self) -> bool:
    return self.use_kernel

  def init(self, b: int, h: int, d: int):
    return kvc.pq_cache_init(b, h, d, self.pq_cfg, self.spec.dtype,
                             self.spec.device)

  def prefill(self, k, v, weights=None, lengths=None):
    if weights is None:
      weights = torch.ones(k.shape[:3], dtype=torch.float32, device=k.device)
    return kvc.pq_cache_prefill(k, v, weights, self.pq_cfg, length=lengths,
                                use_kernel=self.use_kernel)

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

  def append_and_attend_paged(self, resident_leaves, pool_leaves, layer,
                              tables, q, k_new, v_new, lengths):
    sink_k, sink_v, recent_k, recent_v, kcb, vcb, _, _ = resident_leaves
    kip, vip = pool_leaves[6:]
    (out, sink_k, sink_v, recent_k, recent_v, kip, vip) = \
        kvc.pq_cache_paged_step(
            sink_k, sink_v, recent_k, recent_v, kcb, vcb, kip, vip, layer,
            tables, q, k_new, v_new, lengths, self.pq_cfg,
            self.spec.sm_scale(q.shape[-1]))
    return (out,
            [sink_k, sink_v, recent_k, recent_v, kcb, vcb, None, None],
            [None, None, None, None, None, None, kip, vip])

  def paged_axes(self):
    # only the per-token PQ codes page; sink/recent rings and the codebooks
    # are fixed-size per request and stay resident
    return kvc.PQLayerCache(
        sink_k=RESIDENT, sink_v=RESIDENT,
        recent_k=RESIDENT, recent_v=RESIDENT,
        key_codebooks=RESIDENT, value_codebooks=RESIDENT,
        key_indices=2, value_indices=2)

  def bytes(self, b: int, h: int, d: int) -> dict:
    return kvc.pq_cache_bytes(self.pq_cfg, b, h, d)

  def paged_capacity(self) -> int:
    return self.pq_cfg.body_capacity

  def token_extent(self, length: int) -> int:
    # body offsets are positions [sink, length - recent): the sink/recent
    # tokens live in the resident rings, not in paged storage
    used = length - self.pq_cfg.sink - self.pq_cfg.recent
    return min(max(used, 0), self.pq_cfg.body_capacity)
