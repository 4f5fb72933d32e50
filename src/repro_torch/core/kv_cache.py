"""KV-cache structures: exact and PQ-compressed (AQPIM §III-A/H layout).

Port of `repro.core.kv_cache` (contiguous and paged layouts; exact, packed
exact and PQ stores).  PQ cache layout per layer:

  [ sink (exact) | PQ body (codebooks + per-token indices) | recent ring (exact) ]

At decode the new token enters the recent ring; the entry it evicts is
encoded against the codebook page and its indices land in the body.
Codebooks stay fixed after prefill.

Every function takes the batch written out (leading B) in place of the
reference's `vmap` over requests; per-request `lengths` (B,) let rows sit at
different positions.  Updates of per-slot state are functional (new
tensors, inputs untouched), as in the reference, so one prefilled cache can
feed several decode runs.  The paged steps are the exception: they write
their rows into the shared block pools in place (see `pq_cache_paged_step`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import pq, pq_attention, windowed
from repro_torch.kernels import ops as kops
from repro_torch.kernels import packing


def as_lengths(length, b: int, device=None) -> torch.Tensor:
  """Normalize a scalar length or per-request (B,) lengths to (B,) int32."""
  ln = torch.as_tensor(length, dtype=torch.int32, device=device)
  if ln.dim() == 0:
    return ln.expand(b).clone()
  return ln.reshape(b)


# ---------------------------------------------------------------------------
# Block-indexed storage primitives (paged KV memory)
#
# A paged cache stores a token-axis leaf as fixed-size blocks in a shared
# physical pool; a per-request block table maps logical token-block j to a
# physical pool block.  `core.cache_layout.PagedLayout` builds on these.
# ---------------------------------------------------------------------------

def blockify(x: torch.Tensor, axis: int, block: int) -> torch.Tensor:
  """Split token axis `axis` of a dense leaf into leading blocks:
  (..., N, ...) with N = nb*block -> (nb, ..., block, ...)."""
  n = x.shape[axis]
  if n % block:
    raise ValueError(f"token axis {n} not divisible by block {block}")
  x = x.reshape(x.shape[:axis] + (n // block, block) + x.shape[axis + 1:])
  return torch.movedim(x, axis, 0)


def unblockify(blocks: torch.Tensor, axis: int) -> torch.Tensor:
  """Inverse of `blockify`: (nb, ..., block, ...) -> dense (..., N, ...)."""
  x = torch.movedim(blocks, 0, axis)
  return x.reshape(x.shape[:axis] + (x.shape[axis] * x.shape[axis + 1],)
                   + x.shape[axis + 2:])


def gather_blocks(pool: torch.Tensor, table: torch.Tensor,
                  axis: int) -> torch.Tensor:
  """One request's dense leaf view from the physical pool.

  pool (P+1, ...block leaf...) indexed by table (nb,) -> dense leaf whose
  token axis sits at `axis`.  Unallocated logical blocks point at the trash
  block; their rows land at positions >= the request's length and are
  masked inside every policy's attend path.
  """
  return unblockify(pool[table.long()], axis)


def scatter_blocks(pool: torch.Tensor, table: torch.Tensor,
                   dense: torch.Tensor, axis: int) -> torch.Tensor:
  """Write a request's dense leaf back into its pool blocks (inverse of
  `gather_blocks`), in place: the pool is shared storage, and a functional
  copy of it per write would cost the whole pool.  Duplicate table entries
  only ever aim at the trash block, whose content is never read.  Returns
  `pool`."""
  block = pool.shape[axis + 1]
  pool[table.long()] = blockify(dense, axis, block).to(pool.dtype)
  return pool


class PQCacheConfig(NamedTuple):
  """Static geometry of a PQ cache."""
  sink: int = 8            # exact sink tokens (paper §IV-A)
  recent: int = 32         # exact sliding-window tokens (= t of Eq. 1)
  body_capacity: int = 0   # max PQ-compressed tokens (multiple of n_windows)
  n_windows: int = 1       # codebook pages (paper: 1 suffices for long context)
  pq: pq.PQConfig = pq.PQConfig()

  @property
  def window_len(self) -> int:
    return self.body_capacity // self.n_windows

  def capacity(self) -> int:
    return self.sink + self.recent + self.body_capacity


class PQLayerCache(NamedTuple):
  """One layer's compressed KV state.  Leading dims (B, H_kv)."""
  sink_k: torch.Tensor          # (B, H, S0, D)
  sink_v: torch.Tensor
  recent_k: torch.Tensor        # (B, H, R, D) ring buffer
  recent_v: torch.Tensor
  key_codebooks: torch.Tensor   # (B, H, nW, m, K, dsub) bf16
  value_codebooks: torch.Tensor
  key_indices: torch.Tensor     # (B, H, Nb, m) uint8 (K<=256) or int16
  value_indices: torch.Tensor


class ExactLayerCache(NamedTuple):
  k: torch.Tensor               # (B, H, N_max, D)
  v: torch.Tensor


# ---------------------------------------------------------------------------
# Exact cache
# ---------------------------------------------------------------------------

def exact_cache_init(b: int, h: int, n_max: int, d: int, dtype,
                     device="cpu") -> ExactLayerCache:
  z = torch.zeros((b, h, n_max, d), dtype=dtype, device=device)
  return ExactLayerCache(k=z, v=z.clone())


def exact_cache_prefill(k: torch.Tensor, v: torch.Tensor,
                        n_max: int) -> ExactLayerCache:
  """k/v (B, H, N, D) -> cache padded to n_max."""
  pad = (0, 0, 0, n_max - k.shape[2])
  return ExactLayerCache(k=torch.nn.functional.pad(k, pad),
                         v=torch.nn.functional.pad(v, pad))


def exact_insert_one(k_c, v_c, k_new, v_new, lengths
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Insert one token per request at position lengths[b].

  k_c/v_c (B, H, N, D); k_new/v_new (B, H, D); lengths (B,) tokens already
  cached.  Shared by the plain and the kernel step.
  """
  n = k_c.shape[2]
  sel = (torch.arange(n, device=k_c.device)[None, :]
         == lengths.long()[:, None])[:, None, :, None]        # (B, 1, N, 1)
  k_c = torch.where(sel, k_new[:, :, None, :].to(k_c.dtype), k_c)
  v_c = torch.where(sel, v_new[:, :, None, :].to(v_c.dtype), v_c)
  return k_c, v_c


def exact_cache_append_and_attend(cache: ExactLayerCache, q, k_new, v_new,
                                  length, scale: float
                                  ) -> Tuple[torch.Tensor, ExactLayerCache]:
  """Plain exact decode step: q (B, Hq, D), k_new/v_new (B, H, D)."""
  b, hq, d = q.shape
  h, n_max = cache.k.shape[1], cache.k.shape[2]
  lengths = as_lengths(length, b, q.device)
  k_c, v_c = exact_insert_one(cache.k, cache.v, k_new, v_new, lengths)
  mask = (torch.arange(n_max, device=q.device)[None, :]
          < (lengths.long() + 1)[:, None])[:, None, :]        # (B, 1, N)
  out = pq_attention.exact_decode_attention(
      q.reshape(b, h, hq // h, d), k_c, v_c, mask, scale)
  return out.reshape(b, hq, d), ExactLayerCache(k=k_c, v=v_c)


def exact_cache_append_and_attend_kernel(cache: ExactLayerCache, q, k_new,
                                         v_new, length, scale: float
                                         ) -> Tuple[torch.Tensor,
                                                    ExactLayerCache]:
  """Exact decode step through the flash-decode kernel (K2)."""
  b, hq, d = q.shape
  h = cache.k.shape[1]
  lengths = as_lengths(length, b, q.device)
  k_c, v_c = exact_insert_one(cache.k, cache.v, k_new, v_new, lengths)
  out = kops.flash_decode(q.reshape(b, h, hq // h, d), k_c, v_c, lengths + 1,
                          scale)
  return out.reshape(b, hq, d), ExactLayerCache(k=k_c, v=v_c)


# ---------------------------------------------------------------------------
# Packed exact cache: sub-byte resident KV (kernels/packing.py block format)
# ---------------------------------------------------------------------------

class PackedExactLayerCache(NamedTuple):
  """Exact KV stored as q4/q5/q8 block-quantized rows (kernels/packing.py).

  The token axis is 2 on every leaf, as in ExactLayerCache, so the paged
  layout pages this state like the dense one: its pool blocks hold codes
  and f16 headers instead of floats.
  """
  k_pack: torch.Tensor          # (B, H, N, d*bits/8) uint8
  k_scale: torch.Tensor         # (B, H, N, G) f16, G = d / group
  k_min: torch.Tensor           # (B, H, N, G) f16
  v_pack: torch.Tensor
  v_scale: torch.Tensor
  v_min: torch.Tensor


def packed_exact_cache_init(b: int, h: int, n_max: int, d: int, bits: int,
                            device="cpu") -> PackedExactLayerCache:
  group = packing.group_size(d)

  def z(width, dtype):
    return torch.zeros((b, h, n_max, width), dtype=dtype, device=device)
  dp, ng = packing.packed_width(d, bits), d // group
  return PackedExactLayerCache(
      k_pack=z(dp, torch.uint8), k_scale=z(ng, torch.float16),
      k_min=z(ng, torch.float16), v_pack=z(dp, torch.uint8),
      v_scale=z(ng, torch.float16), v_min=z(ng, torch.float16))


def packed_exact_cache_prefill(k: torch.Tensor, v: torch.Tensor, n_max: int,
                               bits: int) -> PackedExactLayerCache:
  """k/v (B, H, N, D) -> quantized cache padded to n_max."""
  d = k.shape[-1]
  group = packing.group_size(d)
  pad = (0, 0, 0, n_max - k.shape[2])
  leaves = (packing.pack_rows(k, bits=bits, group=group)
            + packing.pack_rows(v, bits=bits, group=group))
  return PackedExactLayerCache(
      *[torch.nn.functional.pad(x, pad) for x in leaves])


def packed_exact_dequant(cache: PackedExactLayerCache, bits: int,
                         use_kernel: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Whole-store dequant -> (k, v) f32 (..., N, D), the formula K5 applies
  per element; with `use_kernel` the nibble widen runs through K8."""
  d = cache.k_pack.shape[-1] * 8 // bits
  group = packing.group_size(d)
  k = packing.dequant_page(cache.k_pack, cache.k_scale, cache.k_min,
                           bits=bits, group=group, use_kernel=use_kernel)
  v = packing.dequant_page(cache.v_pack, cache.v_scale, cache.v_min,
                           bits=bits, group=group, use_kernel=use_kernel)
  return k, v


def packed_insert_one(cache: PackedExactLayerCache, k_new, v_new, lengths,
                      bits: int) -> PackedExactLayerCache:
  """Quantize one token row per request and insert it at position
  lengths[b] (k_new/v_new (B, H, D)); the packed analogue of
  `exact_insert_one`."""
  d = k_new.shape[-1]
  group = packing.group_size(d)
  rows = (packing.pack_rows(k_new, bits=bits, group=group)
          + packing.pack_rows(v_new, bits=bits, group=group))
  n = cache.k_pack.shape[2]
  sel = (torch.arange(n, device=lengths.device)[None, :]
         == lengths.long()[:, None])[:, None, :, None]        # (B, 1, N, 1)
  return PackedExactLayerCache(*[
      torch.where(sel, row[:, :, None, :].to(buf.dtype), buf)
      for buf, row in zip(cache, rows)])


def packed_exact_cache_append_and_attend(
    cache: PackedExactLayerCache, q, k_new, v_new, length, scale: float,
    bits: int, use_kernel: bool = False
) -> Tuple[torch.Tensor, PackedExactLayerCache]:
  """Contiguous packed decode step: quantize-insert the new row, then attend
  over the dequantized store: with `use_kernel` the dequant widens through
  K8 and K2 attends on the f32 store, else plain masked attention.  q (B,
  Hq, D), k_new/v_new (B, H, D)."""
  b, hq, d = q.shape
  h = cache.k_pack.shape[1]
  lengths = as_lengths(length, b, q.device)
  cache = packed_insert_one(cache, k_new, v_new, lengths, bits)
  k_c, v_c = packed_exact_dequant(cache, bits, use_kernel)   # (B, H, N, D)
  qg = q.reshape(b, h, hq // h, d)
  if use_kernel:
    # K2 reads q in the store's type; f32 holds the bf16 q exactly, as the
    # reference's kernel widens it
    out = kops.flash_decode(qg.float(), k_c, v_c, lengths + 1, scale)
  else:
    n_max = k_c.shape[2]
    mask = (torch.arange(n_max, device=q.device)[None, :]
            < (lengths.long() + 1)[:, None])[:, None, :]      # (B, 1, N)
    out = pq_attention.exact_decode_attention(qg, k_c, v_c, mask, scale)
  return out.reshape(b, hq, d), cache


def packed_exact_cache_paged_step(pool_leaves, layer: int, tables, q, k_new,
                                  v_new, length, scale: float, bits: int):
  """Block-table-native packed decode step: quantize the new row, write its
  codes and headers into the mapped pool block in place, attend through K5
  (pages decoded on load, never densified).

  `pool_leaves` are the six pools in PackedExactLayerCache order, (P+1, L,
  H, block, x) with x = d*bits/8 | G | G; tables (B, nb) int32.  The row
  lands as in `exact_cache_paged_step` (`index_put_`, not accumulating; an
  inactive slot aims at the trash block).  Returns (out (B, Hq, D), pools).
  """
  b, hq, d = q.shape
  h = pool_leaves[0].shape[2]
  block = pool_leaves[0].shape[3]
  group = packing.group_size(d)
  lengths = as_lengths(length, b, q.device)
  ln = lengths.long()
  pids = tables.long()[torch.arange(b, device=q.device), ln // block]
  rows = ln % block
  new = (packing.pack_rows(k_new, bits=bits, group=group)
         + packing.pack_rows(v_new, bits=bits, group=group))
  for pool, row in zip(pool_leaves, new):
    pool[pids, layer, :, rows] = row.to(pool.dtype)
  out = kops.packed_paged_flash_decode(
      q.reshape(b, h, hq // h, d), *pool_leaves, tables, layer, lengths + 1,
      scale, bits)
  return out.reshape(b, hq, d), list(pool_leaves)


# ---------------------------------------------------------------------------
# PQ cache
# ---------------------------------------------------------------------------

def index_storage_dtype(cfg: PQCacheConfig) -> torch.dtype:
  """Index width: uint8 at K<=256, else int16."""
  return torch.uint8 if cfg.pq.k <= 256 else torch.int16


def pq_cache_bytes(cfg: PQCacheConfig, b: int, h: int, d: int) -> dict:
  """Target-hardware byte accounting (bf16 exact rows, 16-bit codebooks,
  indices of `index_bytes`), as the reference's."""
  fp = 2
  exact = (cfg.sink + cfg.recent) * d * fp * 2
  cb = cfg.n_windows * cfg.pq.m * cfg.pq.k * (d // cfg.pq.m) * fp * 2
  idx = cfg.body_capacity * cfg.pq.m * cfg.pq.index_bytes() * 2
  per_head = exact + cb + idx
  equivalent_exact = cfg.capacity() * d * fp * 2
  return dict(per_head_bytes=per_head, total_bytes=per_head * b * h,
              equivalent_exact_bytes=equivalent_exact * b * h,
              reduction_ratio=equivalent_exact / per_head)


def pq_cache_init(b: int, h: int, d: int, cfg: PQCacheConfig,
                  dtype=torch.bfloat16, device="cpu") -> PQLayerCache:
  m, k = cfg.pq.m, cfg.pq.k
  dsub = d // m
  idt = index_storage_dtype(cfg)

  def z(shape, dt):
    return torch.zeros(shape, dtype=dt, device=device)
  return PQLayerCache(
      sink_k=z((b, h, cfg.sink, d), dtype),
      sink_v=z((b, h, cfg.sink, d), dtype),
      recent_k=z((b, h, cfg.recent, d), dtype),
      recent_v=z((b, h, cfg.recent, d), dtype),
      # bf16 codebook storage; f32 at compute sites
      key_codebooks=z((b, h, cfg.n_windows, m, k, dsub), torch.bfloat16),
      value_codebooks=z((b, h, cfg.n_windows, m, k, dsub), torch.bfloat16),
      key_indices=z((b, h, cfg.body_capacity, m), idt),
      value_indices=z((b, h, cfg.body_capacity, m), idt),
  )


def _build_body(kp, vp, wp, mask, cfg: PQCacheConfig, use_kernel: bool):
  """Cluster and encode the padded body of K, then of V (in turn, so only
  one of them holds k-means temporaries at a time); every k-means
  assignment runs through K6 and every update through B0 with
  `use_kernel`."""
  k_cb, k_idx = windowed.windowed_build_codebooks(
      kp, wp, cfg.pq, cfg.n_windows, mask=mask, use_kernel=use_kernel)
  k_cb = k_cb.to(torch.bfloat16)
  v_cb, v_idx = windowed.windowed_build_codebooks(
      vp, wp, cfg.pq, cfg.n_windows, mask=mask, use_kernel=use_kernel)
  idt = index_storage_dtype(cfg)
  return (k_cb, v_cb.to(torch.bfloat16), k_idx.to(idt), v_idx.to(idt))


def _pq_prefill_ragged(k, v, weights, lengths, cfg: PQCacheConfig,
                       use_kernel: bool) -> PQLayerCache:
  """PQ prefill with per-request valid lengths (right-padded inputs); the
  reference's `_pq_prefill_one` with the batch written out.

  Token p >= sink lives at ring slot (p - sink) % recent; body offsets are
  positions [sink, length - recent).  Padding beyond `length` is masked out
  of clustering and never becomes visible.
  """
  b, h, n, d = k.shape
  s0, r, nb = cfg.sink, cfg.recent, cfg.body_capacity
  if n < s0 + r:
    raise ValueError(f"prefill capacity {n} < sink+recent {s0 + r}")
  if n - s0 - r > nb:
    raise ValueError(f"prefill capacity {n} can overflow body capacity {nb} "
                     f"(sink={s0}, recent={r})")
  dev = k.device
  lengths = lengths.long()
  start = torch.clamp(lengths - r, 0, n - r)                      # (B,)
  pos = (start[:, None] + torch.arange(r, device=dev))             # (B, r)
  slots = (torch.arange(r, device=dev)[None, :] + start[:, None] - s0) % r

  def ring(x):
    tok = torch.gather(x, 2, pos[:, None, :, None].expand(b, h, r, d))
    out = torch.zeros((b, h, r, d), dtype=x.dtype, device=dev)
    return out.scatter(2, slots[:, None, :, None].expand(b, h, r, d), tok)

  pad = max(s0 + nb - n, 0)
  kp = torch.nn.functional.pad(k, (0, 0, 0, pad))[:, :, s0:s0 + nb]
  vp = torch.nn.functional.pad(v, (0, 0, 0, pad))[:, :, s0:s0 + nb]
  wp = torch.nn.functional.pad(weights, (0, pad))[:, :, s0:s0 + nb]
  body_n = torch.clamp(lengths - s0 - r, 0, nb)
  mask = (torch.arange(nb, device=dev)[None, :] < body_n[:, None])
  k_cb, v_cb, k_idx, v_idx = _build_body(
      kp, vp, wp, mask[:, None, :].expand(b, h, nb), cfg, use_kernel)
  return PQLayerCache(
      sink_k=k[:, :, :s0], sink_v=v[:, :, :s0],
      recent_k=ring(k), recent_v=ring(v),
      key_codebooks=k_cb, value_codebooks=v_cb,
      key_indices=k_idx, value_indices=v_idx)


def pq_cache_prefill(k, v, weights, cfg: PQCacheConfig,
                     length: Optional[torch.Tensor] = None,
                     use_kernel: bool = False) -> PQLayerCache:
  """Compress a prefilled KV (B, H, N, D) into the PQ cache (paper Fig. 3a
  prefill step 3).  Body tokens are positions [sink, N - recent), placed at
  body offsets [0, N - sink - recent); `weights` (B, H, N) are the Eq. 1
  importance weights; `length` (B,) per-request lengths or None for N;
  `use_kernel` runs the codebook build's assignments through K6 and its
  updates through B0."""
  b, h, n, d = k.shape
  if length is not None:
    return _pq_prefill_ragged(k, v, weights, as_lengths(length, b, k.device),
                              cfg, use_kernel)
  s0, r, nb = cfg.sink, cfg.recent, cfg.body_capacity
  if n < s0 + r:
    raise ValueError(f"prefill length {n} < sink+recent {s0 + r}")
  body_n = n - s0 - r
  if body_n > nb:
    raise ValueError(f"body {body_n} exceeds capacity {nb}")
  dev = k.device
  # ring layout: token (s0 + i) lives at slot i % r
  slots = (torch.arange(r, device=dev) + (n - r - s0)) % r
  recent_k = torch.zeros((b, h, r, d), dtype=k.dtype, device=dev)
  recent_v = torch.zeros((b, h, r, d), dtype=v.dtype, device=dev)
  recent_k[:, :, slots] = k[:, :, n - r:]
  recent_v[:, :, slots] = v[:, :, n - r:]

  # pad the body to full capacity so window boundaries are static
  pad = nb - body_n
  body_k = torch.nn.functional.pad(k[:, :, s0:n - r], (0, 0, 0, pad))
  body_v = torch.nn.functional.pad(v[:, :, s0:n - r], (0, 0, 0, pad))
  body_w = torch.nn.functional.pad(weights[:, :, s0:n - r], (0, pad))
  mask = torch.arange(nb, device=dev) < body_n
  k_cb, v_cb, k_idx, v_idx = _build_body(body_k, body_v, body_w,
                                         mask.expand(b, h, nb), cfg,
                                         use_kernel)
  return PQLayerCache(
      sink_k=k[:, :, :s0], sink_v=v[:, :, :s0],
      recent_k=recent_k, recent_v=recent_v,
      key_codebooks=k_cb, value_codebooks=v_cb,
      key_indices=k_idx, value_indices=v_idx)


class PQRingStep(NamedTuple):
  """Everything one PQ decode step changes except where the encoded indices
  land.  Leading dim B on every field."""
  sink_k: torch.Tensor          # (B, H, S0, D) updated
  sink_v: torch.Tensor
  recent_k: torch.Tensor        # (B, H, R, D) updated
  recent_v: torch.Tensor
  k_idx_new: torch.Tensor       # (B, H, m) encoded eviction (unused when !do_evict)
  v_idx_new: torch.Tensor
  ev: torch.Tensor              # (B,) body offset being filled (clipped)
  do_evict: torch.Tensor        # (B,) bool
  sink_mask: torch.Tensor       # (B, S0)
  rec_mask: torch.Tensor        # (B, R)
  body_len: torch.Tensor        # (B,) valid body tokens after this step


def _pq_ring_step(sink_k, sink_v, recent_k, recent_v, key_codebooks,
                  value_codebooks, k_new, v_new, lengths,
                  cfg: PQCacheConfig) -> PQRingStep:
  """Steps 1-3 of a PQ decode step (the reference's `_pq_ring_step_one`
  with the batch written out): evict -> encode, insert, masks.

  Reads and writes of the single affected ring slot use one-hot masks, so
  untouched rows pass through bit for bit.  lengths (B,) tokens already
  cached (incl. prefill).
  """
  s0, r, nb = cfg.sink, cfg.recent, cfg.body_capacity
  dev = recent_k.device
  b, h = recent_k.shape[:2]
  pos = lengths.long()

  in_sink = pos < s0
  slot = torch.clamp((pos - s0) % r, 0, r - 1)
  evict_pos = pos - s0 - r

  # 1. encode the evicted ring entry into the PQ body
  do_evict = evict_pos >= 0
  ev = torch.clamp(evict_pos, 0, nb - 1)
  win_id = torch.clamp(ev // max(cfg.window_len, 1), 0, cfg.n_windows - 1)
  rsel = (torch.arange(r, device=dev)[None, :]
          == slot[:, None])[:, None, :, None]                 # (B, 1, R, 1)
  old_k = torch.sum(torch.where(rsel, recent_k.float(), 0.0), dim=2)
  old_v = torch.sum(torch.where(rsel, recent_v.float(), 0.0), dim=2)
  wins = win_id[:, None].expand(b, h)
  k_idx_new = windowed.windowed_encode(old_k, key_codebooks, wins)
  v_idx_new = windowed.windowed_encode(old_v, value_codebooks, wins)

  # 2. insert the new token (sink while warming up, else ring)
  sink_sel = ((torch.arange(s0, device=dev)[None, :]
               == torch.clamp(pos, 0, s0 - 1)[:, None])
              & in_sink[:, None])[:, None, :, None]
  ring_sel = ((torch.arange(r, device=dev)[None, :] == slot[:, None])
              & ~in_sink[:, None])[:, None, :, None]

  def insert(buf, sel, val):
    return torch.where(sel, val[:, :, None, :].to(buf.dtype), buf)
  sink_k = insert(sink_k, sink_sel, k_new)
  sink_v = insert(sink_v, sink_sel, v_new)
  recent_k = insert(recent_k, ring_sel, k_new)
  recent_v = insert(recent_v, ring_sel, v_new)

  # 3. masks after insertion
  n_tok = pos + 1
  sink_mask = (torch.arange(s0, device=dev)[None, :]
               < torch.clamp_max(n_tok, s0)[:, None])
  rec_count = torch.clamp(n_tok - s0, 0, r)
  rec_mask = torch.arange(r, device=dev)[None, :] < rec_count[:, None]
  body_len = torch.clamp(n_tok - s0 - r, 0, nb)
  return PQRingStep(
      sink_k=sink_k, sink_v=sink_v, recent_k=recent_k, recent_v=recent_v,
      k_idx_new=k_idx_new, v_idx_new=v_idx_new, ev=ev, do_evict=do_evict,
      sink_mask=sink_mask, rec_mask=rec_mask, body_len=body_len)


def _scatter_evicted(cache: PQLayerCache, step: PQRingStep):
  """Write each evicting row's encoded indices at its body offset (one-hot
  masked row write)."""
  nb = cache.key_indices.shape[2]
  ev_sel = ((torch.arange(nb, device=step.ev.device)[None, :]
             == step.ev[:, None])
            & step.do_evict[:, None])[:, None, :, None]       # (B, 1, nb, 1)

  def scatter(store, new):
    return torch.where(ev_sel, new[:, :, None, :].to(store.dtype), store)
  return (scatter(cache.key_indices, step.k_idx_new),
          scatter(cache.value_indices, step.v_idx_new))


def pq_cache_append_and_attend(cache: PQLayerCache, q, k_new, v_new, length,
                               cfg: PQCacheConfig, scale: float,
                               value_mode: str = "bucket"
                               ) -> Tuple[torch.Tensor, PQLayerCache]:
  """Plain PQ decode step: insert token, evict -> encode, attend jointly on
  sink | body | recent (paper Fig. 3a decode).  q (B, Hq, D)."""
  b, hq, d = q.shape
  h = cache.recent_k.shape[1]
  lengths = as_lengths(length, b, q.device)
  step = _pq_ring_step(cache.sink_k, cache.sink_v, cache.recent_k,
                       cache.recent_v, cache.key_codebooks,
                       cache.value_codebooks, k_new, v_new, lengths, cfg)
  key_indices, value_indices = _scatter_evicted(cache, step)
  nb = cfg.body_capacity
  body_mask = (torch.arange(nb, device=q.device)[None, :]
               < step.body_len[:, None])
  windowed_cb = cfg.n_windows > 1
  seg = pq_attention.PQAttnSegments(
      sink_k=step.sink_k, sink_v=step.sink_v,
      sink_mask=step.sink_mask[:, None, :],
      key_codebook=(cache.key_codebooks if windowed_cb
                    else cache.key_codebooks[:, :, 0]),
      value_codebook=(cache.value_codebooks if windowed_cb
                      else cache.value_codebooks[:, :, 0]),
      key_indices=key_indices, value_indices=value_indices,
      body_mask=body_mask[:, None, :],
      recent_k=step.recent_k, recent_v=step.recent_v,
      recent_mask=step.rec_mask[:, None, :])
  out = pq_attention.pq_decode_attention(
      q.reshape(b, h, hq // h, d), seg, scale, value_mode=value_mode)
  new_cache = PQLayerCache(
      sink_k=step.sink_k, sink_v=step.sink_v,
      recent_k=step.recent_k, recent_v=step.recent_v,
      key_codebooks=cache.key_codebooks,
      value_codebooks=cache.value_codebooks,
      key_indices=key_indices, value_indices=value_indices)
  return out.reshape(b, hq, d), new_cache


def _pq_segments_combine(q, step_masks, sink_k, sink_v, recent_k, recent_v,
                         body, scale: float) -> torch.Tensor:
  """Combine the kernel's body (out, max, denom) with the plain sink and
  recent segment stats.  q (B, H, g, D); masks (B, S0) and (B, R)."""
  sink_mask, rec_mask = step_masks
  s_out, s_m, s_l = pq_attention.segment_attention_stats(
      q, sink_k, sink_v, sink_mask[:, None, :], scale)
  r_out, r_m, r_l = pq_attention.segment_attention_stats(
      q, recent_k, recent_v, rec_mask[:, None, :], scale)
  b_out, b_m, b_l = body
  return kops.combine_attention_segments(
      [b_out, s_out, r_out], [b_m, s_m, r_m], [b_l, s_l, r_l])


def pq_cache_append_and_attend_kernel(cache: PQLayerCache, q, k_new, v_new,
                                      length, cfg: PQCacheConfig,
                                      scale: float
                                      ) -> Tuple[torch.Tensor, PQLayerCache]:
  """PQ decode step with the body through the PQ decode kernel (K1);
  single-window codebooks only."""
  if cfg.n_windows != 1:
    raise ValueError("the kernel path requires a single codebook window")
  b, hq, d = q.shape
  h = cache.recent_k.shape[1]
  lengths = as_lengths(length, b, q.device)
  step = _pq_ring_step(cache.sink_k, cache.sink_v, cache.recent_k,
                       cache.recent_v, cache.key_codebooks,
                       cache.value_codebooks, k_new, v_new, lengths, cfg)
  key_indices, value_indices = _scatter_evicted(cache, step)
  qg = q.reshape(b, h, hq // h, d)
  body = kops.pq_decode_attention(
      qg, cache.key_codebooks[:, :, 0], cache.value_codebooks[:, :, 0],
      key_indices, value_indices, step.body_len[:, None].expand(b, h), scale)
  out = _pq_segments_combine(
      qg, (step.sink_mask, step.rec_mask), step.sink_k, step.sink_v,
      step.recent_k, step.recent_v, body, scale)
  new_cache = PQLayerCache(
      sink_k=step.sink_k, sink_v=step.sink_v,
      recent_k=step.recent_k, recent_v=step.recent_v,
      key_codebooks=cache.key_codebooks,
      value_codebooks=cache.value_codebooks,
      key_indices=key_indices, value_indices=value_indices)
  return out.reshape(b, hq, d), new_cache


# ---------------------------------------------------------------------------
# Block-table-native decode steps (paged layout)
# ---------------------------------------------------------------------------

def pq_cache_paged_step(sink_k, sink_v, recent_k, recent_v, key_codebooks,
                        value_codebooks, key_index_pool, value_index_pool,
                        layer: int, tables, q, k_new, v_new, length,
                        cfg: PQCacheConfig, scale: float):
  """Block-table-native PQ decode step: pools read in place, one row written.

  Rings (B, H, S0|R, D), codebooks (B, H, nW, m, K, dsub); index pools
  (P+1, L, H, block, m) narrow int shared by every layer; `layer` a Python
  int; tables (B, nb) int32 (trash = P); q (B, Hq, D), k_new/v_new (B, H, D).
  Returns (out (B, Hq, D), updated rings..., the pools).

  The evicted ring entry's encoded indices land directly in pool block
  tables[b, ev // block] of plane `layer`, written in place with
  `index_put_` (no copy of the pool, unlike the reference's functional
  `.at[].set`).  Rows that evict nothing, and inactive slots, aim at the
  trash block; their duplicate indices there are harmless only because the
  trash block is never read, so the write must not accumulate.  The body
  kernel (K3) then streams exactly the table-mapped blocks.
  """
  if cfg.n_windows != 1:
    raise ValueError("the kernel path requires a single codebook window")
  b, hq, d = q.shape
  h = recent_k.shape[1]
  block = key_index_pool.shape[3]
  trash = key_index_pool.shape[0] - 1
  lengths = as_lengths(length, b, q.device)
  step = _pq_ring_step(sink_k, sink_v, recent_k, recent_v, key_codebooks,
                       value_codebooks, k_new, v_new, lengths, cfg)

  rows_b = torch.arange(b, device=q.device)
  pids = torch.where(step.do_evict, tables.long()[rows_b, step.ev // block],
                     torch.full_like(step.ev, trash))
  rows = step.ev % block
  key_index_pool[pids, layer, :, rows] = step.k_idx_new.to(
      key_index_pool.dtype)
  value_index_pool[pids, layer, :, rows] = step.v_idx_new.to(
      value_index_pool.dtype)

  qg = q.reshape(b, h, hq // h, d)
  body = kops.pq_decode_attention_paged(
      qg, key_codebooks[:, :, 0], value_codebooks[:, :, 0], key_index_pool,
      value_index_pool, tables, layer, step.body_len, scale)
  out = _pq_segments_combine(
      qg, (step.sink_mask, step.rec_mask), step.sink_k, step.sink_v,
      step.recent_k, step.recent_v, body, scale)
  return (out.reshape(b, hq, d), step.sink_k, step.sink_v, step.recent_k,
          step.recent_v, key_index_pool, value_index_pool)


def exact_cache_paged_step(k_pool, v_pool, layer: int, tables, q, k_new,
                           v_new, length, scale: float):
  """Block-table-native exact decode step: insert one row, attend in place.

  Pools (P+1, L, H, block, D); tables (B, nb) int32.  The new row lands at
  pool block tables[b, length // block], row length % block, of plane
  `layer`, written in place (`index_put_`, not accumulating; an inactive
  slot's table is all trash, so its row aims at the trash block, which is
  never read).  Returns (out (B, Hq, D), k_pool, v_pool).
  """
  b, hq, d = q.shape
  h = k_pool.shape[2]
  block = k_pool.shape[3]
  lengths = as_lengths(length, b, q.device)
  ln = lengths.long()
  pids = tables.long()[torch.arange(b, device=q.device), ln // block]
  rows = ln % block
  k_pool[pids, layer, :, rows] = k_new.to(k_pool.dtype)
  v_pool[pids, layer, :, rows] = v_new.to(v_pool.dtype)
  out = kops.paged_flash_decode(q.reshape(b, h, hq // h, d), k_pool, v_pool,
                                tables, layer, lengths + 1, scale)
  return out.reshape(b, hq, d), k_pool, v_pool
