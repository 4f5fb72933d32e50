"""Config schema: architecture, shapes, PQ/runtime settings.

A plain frozen dataclass with the same fields and defaults as the reference
`repro.configs.base.ModelConfig`; each arch module holds the published
hyperparameters plus a `REDUCED` smoke-scale variant for CPU tests.  Fields
that select features this port does not run yet (sharding, training, other
layouts) are kept so the two config sets stay field-for-field equal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.common.types import torch_dtype
from repro_torch.core import kv_cache as kvc
from repro_torch.core import pq as pqlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
  name: str
  family: str                  # dense | moe | ssm | hybrid | audio | vlm
  n_layers: int
  d_model: int
  n_heads: int
  n_kv_heads: int
  d_ff: int
  vocab_size: int
  head_dim: int = 0            # 0 -> d_model // n_heads

  # MoE
  n_experts: int = 0
  top_k: int = 0
  moe_d_ff: int = 0
  n_shared_experts: int = 0
  capacity_factor: float = 1.25

  # SSM / hybrid
  attn_free: bool = False      # rwkv6: no attention, no KV cache
  hybrid: bool = False         # hymba: parallel attn + SSM heads
  ssm_state: int = 0
  ssm_d_inner: int = 0

  # multimodal
  cross_attn_period: int = 0   # every k-th layer is cross-attn (vlm)
  n_modal_tokens: int = 0      # precomputed patch/frame embeddings (stub frontend)
  frontend: str = "none"       # none | audio_frames | vision_patches

  rope_theta: float = 500000.0
  norm_eps: float = 1e-5
  dtype_str: str = "bfloat16"

  # runtime knobs (overridden per run via dataclasses.replace)
  attn_block: int = 512
  decode_cache_len: int = 4096     # exact-cache capacity for decode
  cache_policy: str = "pq"         # registry key: exact | pq | skvq | snapkv |
                                   # streamingllm | pqcache (core/cache_registry)
  cache_layout: str = "contiguous"  # physical KV storage: contiguous | paged
                                    # | tiered (core/cache_layout)
  scheduler: str = "fifo"          # serve-engine admission: fifo | sjf | paged
                                   # | tiered (launch/scheduler)
  kv_block_size: int = 16          # paged-layout token-block granularity
  decode_kernel: str = "auto"      # decode attention implementation: torch
                                   # (plain PyTorch) | cuda (hand-written
                                   # kernels, sm_90 only) | auto (by the
                                   # device of the tensors);
                                   # core/decode_dispatch registry
  host_blocks: Optional[int] = None  # tiered-layout host (tier 1) pool size
                                     # in blocks; None -> layout default (4x
                                     # device), 0 -> no host tier (exhaustion
                                     # falls back to recompute preemption)
  spill_codec: str = "raw"         # tiered-layout exact-KV spill codec: any
                                   # core.tiers.SPILL_CODECS key (raw | int8
                                   # | q4 | q8; PQ codes always spill
                                   # verbatim — they ARE the compressed form)
  kv_resident_codec: str = "none"  # exact-policy resident KV store: none
                                   # (dense floats) | q4 | q5 | q8 (sub-byte
                                   # packed pages decoded in-kernel —
                                   # kernels/packing.py block format)
  prefix_cache: bool = False       # share prompt-prefix KV blocks across
                                   # requests (copy-on-write tables +
                                   # suffix-only prefill; paged/tiered
                                   # layouts only, token-exact under greedy)
  prefix_cache_blocks: Optional[int] = None  # device blocks the prefix index
                                             # may pin (refcount+LRU budget);
                                             # None -> half the device pool
  stream_window: int = 512         # streamingllm sliding window (clamped to
                                   # context; paged layout ring-reuses blocks
                                   # that age out of it)
  pq_enabled: bool = True          # legacy toggle: False downgrades "pq"->"exact"
  pq_m: int = 32                   # paper Table II optimum
  pq_k: int = 512                  # paper Table III optimum
  pq_sink: int = 8                 # paper §IV-A
  pq_recent: int = 32              # paper §IV-A (= t of Eq. 1)
  pq_windows: int = 1              # paper §III-B: one page suffices
  remat: bool = True
  unroll_layers: bool = False      # python-loop layers (cost-model validation:
                                   # XLA cost_analysis counts while bodies once)
  # beyond-paper performance features (§Perf hillclimbs)
  weight_quant: str = "none"       # "int8": serve weights stored int8+scale
  parallel_block: bool = False     # PaLM-style fused attn+FFN residual: halves
                                   # the TP all-reduce count per layer
  context_parallel: bool = False   # prefill: sequence on the model axis,
                                   # weights replicated, per-layer KV all-gather
                                   # (small-model prefill collective fix)
  moe_a2a_quant: bool = False      # int8 rows across the EP all-to-alls
  microbatches: int = 1            # gradient-accumulation chunks per step
  fsdp: bool = False               # 2D weight sharding (model x data): params/
                                   # optimizer fully sharded, weight all-gather
                                   # on use (required: 405B does not fit 16 GB
                                   # HBM with TP-only sharding)

  # provenance
  source: str = ""
  verified: str = ""

  def __post_init__(self):
    if self.head_dim == 0:
      object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

  @property
  def dtype(self) -> torch.dtype:
    return torch_dtype(self.dtype_str)

  @property
  def supports_pq(self) -> bool:
    return not self.attn_free

  def resolved_cache_policy(self) -> str:
    """Effective registry key: legacy `pq_enabled=False` means exact; families
    without attention never build a KV policy at all."""
    if not self.supports_pq:
      return "exact"
    if self.cache_policy == "pq" and not self.pq_enabled:
      return "exact"
    return self.cache_policy

  def make_cache_policy(self, context_len: int, device="cpu"):
    """Build the configured CachePolicy for a given max context and the
    device its state lives on (None for families without an attention KV
    cache)."""
    from repro_torch.core import cache_api, cache_registry
    if self.attn_free:
      return None
    name = self.resolved_cache_policy()
    spec = cache_api.CacheSpec(
        capacity=context_len, head_dim=self.head_dim, dtype=self.dtype,
        sink=self.pq_sink, recent=self.pq_recent,
        # the streaming window is clamped to small contexts (window ==
        # capacity keeps everything, the same behaviour)
        window=min(self.stream_window, context_len),
        block=(self.kv_block_size
               if self.cache_layout in ("paged", "tiered") else 0),
        spill_codec=self.spill_codec,
        kv_resident_codec=self.kv_resident_codec,
        decode_kernel=self.decode_kernel, device=str(device),
        pq=self.pq_cache_config(context_len) if name == "pq" else None)
    return cache_registry.make(name, spec)

  def pq_cache_config(self, context_len: int) -> Optional[kvc.PQCacheConfig]:
    """PQ cache geometry for a given max context.

    None whenever the *effective* cache policy is not "pq" — so the cost
    model, roofline, and dry-run byte accounting stay in lockstep with the
    policy the model actually runs (not just the legacy pq_enabled flag).
    """
    if self.resolved_cache_policy() != "pq":
      return None
    body = max(context_len - self.pq_sink - self.pq_recent, self.pq_windows)
    # round body capacity to a multiple of windows AND the kernel block (512)
    blk = 512 if context_len >= 4096 else 64
    mult = self.pq_windows * blk
    body = -(-body // mult) * mult
    m = self.pq_m
    while self.head_dim % m != 0:
      m //= 2
    return kvc.PQCacheConfig(
        sink=self.pq_sink, recent=self.pq_recent, body_capacity=body,
        n_windows=self.pq_windows,
        pq=pqlib.PQConfig(m=m, k=self.pq_k))
