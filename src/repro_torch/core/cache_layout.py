"""`CacheLayout` API: where a policy's KV state lives (port of
`repro.core.cache_layout`, the `contiguous` and `paged` layouts).

  ``ContiguousLayout``  one capacity-sized slab per engine slot;
  ``PagedLayout``       a shared pool of fixed-size token blocks with a
                        `BlockAllocator` and per-request block tables.

A layout pages any policy's state through the codec surface on
`CachePolicy` (`paged_axes` / `token_extent` / `paged_capacity`): AQPIM's PQ
code rows page exactly the way exact K/V does, while its codebooks and
sink/recent rings stay resident per slot.

`PagedLayout` decodes through one of two programs, chosen once from the
policy: where the policy runs its kernel (`block_native`), the kernels K3/K4
read the table-mapped pool pages in place and the step writes one row per
slot (`_decode_native_body`); otherwise the table-mapped blocks are gathered
into dense per-layer caches, `Model.decode_step` runs on them and the result
is scattered back (`_decode_fused_body`).  Pool storage is written in place.

Not ported here: the prefix cache (ROADMAP A10), the host mirror and fault
hooks (A12), shard plans (A13) and `TieredLayout` (A9).  Their constructor
arguments raise `NotImplementedError` when set.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import cache_registry
from repro_torch.core import kv_cache as kvc
from repro_torch.core.cache_api import RESIDENT


def _refuse_unported(host_blocks=None, prefix_cache=False,
                     prefix_cache_blocks=None, shard_plan=None,
                     shard_redundancy="none") -> None:
  """Constructor arguments of branches this port does not have yet."""
  if host_blocks is not None:
    raise NotImplementedError("host_blocks: the tiered layout is not ported "
                              "yet (ROADMAP A9)")
  if prefix_cache or prefix_cache_blocks is not None:
    raise NotImplementedError("prefix_cache: the prefix cache is not ported "
                              "yet (ROADMAP A10)")
  if shard_redundancy not in (None, "none"):
    raise NotImplementedError("shard_redundancy: the host mirror is not "
                              "ported yet (ROADMAP A12)")
  if shard_plan is not None:
    raise NotImplementedError("shard_plan: multi-GPU serving is not ported "
                              "yet (ROADMAP A13)")


class BlockAllocator:
  """Free-list allocator over `num_blocks` physical token blocks.

  Owners are opaque tags (the engine uses slot indices).  Every transition
  is checked: allocating a held block, freeing a free block, or freeing a
  hold the owner does not have raises.
  """

  def __init__(self, num_blocks: int):
    if num_blocks <= 0:
      raise ValueError(f"num_blocks must be positive, got {num_blocks}")
    self.num_blocks = num_blocks
    self._free: collections.deque = collections.deque(range(num_blocks))
    self._holders: Dict[int, collections.Counter] = {}

  @property
  def free_count(self) -> int:
    return len(self._free)

  @property
  def allocated_count(self) -> int:
    return len(self._holders)

  def alloc(self, n: int, owner: Any = None) -> Optional[List[int]]:
    """Allocate `n` blocks for `owner`; None (and no change) if unavailable."""
    if n < 0:
      raise ValueError(f"cannot allocate {n} blocks")
    if n > len(self._free):
      return None
    ids = [self._free.popleft() for _ in range(n)]
    for i in ids:
      if i in self._holders:
        raise AssertionError(f"free list returned owned block {i}")
      self._holders[i] = collections.Counter({owner: 1})
    return ids

  def free(self, ids: Sequence[int], owner: Any = None) -> None:
    """Drop one hold per id; blocks with no holds left return to the free
    list.  `owner=None` drops the sole holder's hold and refuses on a
    block held by several owners (ambiguous)."""
    for i in ids:
      holders = self._holders.get(i)
      if holders is None:
        raise ValueError(f"double free of block {i}")
      key = owner
      if key is None and None not in holders:
        if len(holders) != 1:
          raise ValueError(
              f"block {i} held by {sorted(map(repr, holders))}; "
              f"anonymous free is ambiguous")
        key = next(iter(holders))
      if holders.get(key, 0) <= 0:
        raise ValueError(
            f"block {i} owned by {sorted(map(repr, holders))}, "
            f"freed by {owner!r}")
      holders[key] -= 1
      if holders[key] == 0:
        del holders[key]
      if not holders:
        del self._holders[i]
        self._free.append(i)

  def owned(self, owner: Any) -> List[int]:
    return [i for i, h in self._holders.items() if h.get(owner, 0) > 0]

  def check(self) -> None:
    """Free list and holder map must partition [0, num_blocks) exactly."""
    free = set(self._free)
    owned = set(self._holders)
    if len(free) != len(self._free):
      raise AssertionError("duplicate ids in free list")
    if free & owned:
      raise AssertionError(f"blocks both free and owned: {free & owned}")
    if free | owned != set(range(self.num_blocks)):
      raise AssertionError("allocator leaked or invented blocks")
    for i, holders in self._holders.items():
      if any(c <= 0 for c in holders.values()) or not holders:
        raise AssertionError(f"block {i} held with non-positive hold count")


class BlockTableManager:
  """Host-side paged bookkeeping: per-slot block tables over an allocator.

  Pure NumPy/Python, no device storage.  Logical block j of a slot covers
  paged tokens [j*block, (j+1)*block); unallocated entries hold the trash
  sentinel (`num_blocks`), which physically exists in the pool so reads and
  writes of not-yet-filled blocks stay in bounds and never touch another
  request.
  """

  def __init__(self, num_blocks: int, blocks_per_req: int, max_slots: int,
               block: int, policy):
    self.allocator = BlockAllocator(num_blocks)
    self.block = block
    self.blocks_per_req = blocks_per_req
    self.trash = num_blocks
    self.tables = np.full((max_slots, blocks_per_req), self.trash, np.int32)
    self._hwm = np.zeros(max_slots, np.int64)   # logical blocks ever grown to
    self.policy = policy
    self.peak_allocated = 0
    # peak distinct table-mapped blocks: the concurrent working set
    self.peak_mapped = 0

  @property
  def free_count(self) -> int:
    return self.allocator.free_count

  @property
  def allocated_count(self) -> int:
    return self.allocator.allocated_count

  def blocks_for(self, length: int) -> int:
    """Blocks needed to hold `length` cached tokens under this codec."""
    return -(-self.policy.token_extent(int(length)) // self.block)

  def high_water(self, slot: int) -> int:
    """Logical blocks this slot has ever grown to."""
    return int(self._hwm[slot])

  def need_blocks(self, slot: int, length: int) -> int:
    return max(self.blocks_for(length) - int(self._hwm[slot]), 0)

  def admit(self, slot: int, length: int) -> bool:
    if self._hwm[slot] != 0 or (self.tables[slot] != self.trash).any():
      raise AssertionError(f"slot {slot} admitted while occupied")
    return self.ensure(slot, length)

  def ensure(self, slot: int, length: int) -> bool:
    """Grow slot to cover `length` tokens; False (no change) on exhaustion."""
    need = self.need_blocks(slot, length)
    if need == 0:
      return True
    ids = self.allocator.alloc(need, owner=slot)
    if ids is None:
      return False
    hwm = int(self._hwm[slot])
    self.tables[slot, hwm:hwm + need] = ids
    self._hwm[slot] = hwm + need
    self._note_peaks()
    return True

  def reclaim(self, slot: int, length: int) -> int:
    """Ring-reuse: free blocks the codec has masked out forever.  Returns
    blocks freed."""
    dead = self.policy.dead_below(int(length))
    if dead <= 0:
      return 0
    first = -(-self.policy.pinned_tokens() // self.block)
    last = min(dead // self.block, int(self._hwm[slot]))
    freed = 0
    for j in range(first, last):
      pid = int(self.tables[slot, j])
      if pid != self.trash:
        self.allocator.free([pid], owner=slot)
        self.tables[slot, j] = self.trash
        freed += 1
    return freed

  def release(self, slot: int) -> None:
    ids = [int(x) for x in self.tables[slot] if x != self.trash]
    if ids:
      self.allocator.free(ids, owner=slot)
    self.tables[slot, :] = self.trash
    self._hwm[slot] = 0

  def _note_peaks(self) -> None:
    self.peak_allocated = max(self.peak_allocated, self.allocated_count)
    live = self.tables[self.tables != self.trash]
    self.peak_mapped = max(self.peak_mapped, len(set(live.tolist())))

  def check_invariants(self) -> None:
    self.allocator.check()
    for slot in range(self.tables.shape[0]):
      row_list = self.tables[slot][self.tables[slot] != self.trash].tolist()
      row = set(row_list)
      if len(row) != len(row_list):
        raise AssertionError(
            f"slot {slot} maps a physical block twice: {sorted(row_list)}")
      if row != set(self.allocator.owned(slot)):
        raise AssertionError(
            f"slot {slot} table/owner mismatch: {row} vs "
            f"{set(self.allocator.owned(slot))}")


class CacheLayout:
  """Physical-storage protocol between a built `Model` and the serve engine.

  The engine asks the layout to `admit` a prefilled request into a slot,
  `ensure` growth room before a decode step, `decode` one batched step over
  the layout's own storage, and `release` on finish.  Block-pool methods
  are no-ops for layouts without a pool, so schedulers can query them
  uniformly.
  """
  name: str = "base"
  #: True if this layout manages a shared block pool (pool-gating schedulers
  #: require one).
  pooled: bool = False

  def fits(self, total_len: int, prompt_len: int = 0) -> bool:
    """Can a request of `total_len` cached tokens ever be served alone?"""
    return True

  def can_admit(self, prompt_len: int, total_len: Optional[int] = None
                ) -> bool:
    """Is there storage to admit a prompt of this length right now?"""
    return True

  def admit(self, slot: int, slot_cache: List[Any], prompt_len: int) -> None:
    raise NotImplementedError

  def release(self, slot: int) -> None:
    raise NotImplementedError

  def need_blocks(self, slot: int, target_len: int) -> int:
    return 0

  def ensure(self, slot: int, target_len: int) -> bool:
    return True

  def reclaim(self, slot: int, length: int) -> int:
    return 0

  @property
  def free_blocks(self) -> int:
    return 0

  def decode(self, cur: np.ndarray, lengths: np.ndarray) -> torch.Tensor:
    """Run one batched decode step over this layout's storage; returns
    logits (B, V)."""
    raise NotImplementedError

  def bytes(self, active_slots: int = 0) -> dict:
    raise NotImplementedError

  def __repr__(self) -> str:
    return f"{type(self).__name__}()"


def _to_device(x: np.ndarray, device) -> torch.Tensor:
  return torch.from_numpy(np.ascontiguousarray(x)).to(device)


@cache_registry.register_layout("contiguous")
class ContiguousLayout(CacheLayout):
  """One capacity-sized slab per slot: the model's per-layer caches with
  batch `max_batch`.  Admission copies a prefilled slot cache into batch row
  `slot` in place.  `bytes()` counts every slot at full capacity, whether
  or not a short request sits in it: the number paging exists to shrink."""

  def __init__(self, model, max_batch: int, *,
               block_size: Optional[int] = None,
               num_blocks: Optional[int] = None, **unported):
    del block_size, num_blocks   # no block pool
    _refuse_unported(**unported)
    self.model = model
    self.max_batch = max_batch
    self.storage = model.init_cache(max_batch)

  def admit(self, slot: int, slot_cache, prompt_len: int) -> None:
    del prompt_len  # slabs are capacity-sized regardless
    for layer, one in zip(self.storage, slot_cache):
      for dst, src in zip(layer, one):
        dst[slot].copy_(src[0])

  def release(self, slot: int) -> None:
    pass  # the slab is overwritten by the next admit

  def decode(self, cur, lengths):
    dev = self.model.device
    logits, self.storage = self.model.decode_step(
        _to_device(cur, dev), self.storage, _to_device(lengths, dev))
    return logits

  def bytes(self, active_slots: int = 0) -> dict:
    total = sum(t.nbytes for layer in self.storage for t in layer)
    per_slot = total // max(self.max_batch, 1)
    return dict(kind="contiguous", total_bytes=total,
                per_slot_bytes=per_slot, capacity_bytes=total,
                active_bytes=active_slots * per_slot)


@cache_registry.register_layout("paged")
class PagedLayout(CacheLayout):
  """Block-pooled storage: per-request block tables over a shared pool.

  `storage` holds one tensor per state leaf (the order of `paged_axes`):
  a token-axis leaf (exact K/V, PQ code rows) is a pool `(P+1, L, ...,
  block, ...)` whose index P is the trash block backing unallocated table
  entries; a resident leaf (codebooks, sink/recent rings) is `(L, B, ...)`
  per slot.
  """

  pooled = True

  def __init__(self, model, max_batch: int, *,
               block_size: Optional[int] = None,
               num_blocks: Optional[int] = None, **unported):
    _refuse_unported(**unported)
    policy = model.cache_policy
    self.model = model
    self.max_batch = max_batch
    self.block = int(block_size or policy.spec.block or 16)
    cap = policy.paged_capacity()
    if self.block <= 0 or cap % self.block:
      raise ValueError(
          f"paged token capacity {cap} not divisible by block size "
          f"{self.block} ({type(policy).__name__})")
    self.blocks_per_req = cap // self.block
    self.num_blocks = int(num_blocks or max_batch * self.blocks_per_req)
    self.manager = BlockTableManager(
        self.num_blocks, self.blocks_per_req, max_batch, self.block, policy)
    axes = policy.paged_axes()
    self._state_type = type(axes)
    self._axes = list(axes)

    template = model.init_cache(max_batch)
    self.storage: List[torch.Tensor] = []
    for i, ax in enumerate(self._axes):
      if ax == RESIDENT:           # (L, B, ...) per-slot resident
        self.storage.append(torch.stack([layer[i] for layer in template]))
        continue
      # per layer (B, ..., N at ax, ...) -> pool (P+1, L, ..., block, ...)
      leaf = template[0][i]
      slot_shape = (len(template),) + tuple(leaf.shape[1:])
      pool_shape = ((self.num_blocks + 1,) + slot_shape[:ax] + (self.block,)
                    + slot_shape[ax + 1:])
      self.storage.append(torch.zeros(pool_shape, dtype=leaf.dtype,
                                      device=leaf.device))
    del template

    # the port's Model is the dense family: block-native exactly when the
    # policy runs its kernel
    self.block_native = bool(policy.block_native)
    # layout-constant byte terms of the traffic model: one pool block / one
    # token row across all layers and heads, summed over paged leaves
    self._traffic_per_block = 0
    self._traffic_per_row = 0
    for ax, st in zip(self._axes, self.storage):
      if ax == RESIDENT:
        continue
      pb = st.nbytes // st.shape[0]
      self._traffic_per_block += pb
      self._traffic_per_row += pb // self.block
    # peak per-step traffic snapshot, refreshed while decoding (live tables)
    self.decode_traffic = self.decode_traffic_model()

  # -- the two decode programs -----------------------------------------------
  def _gather(self, storage, tables) -> List[Any]:
    """Dense per-layer caches (batched states) from the pool."""
    leaves = []
    for ax, st in zip(self._axes, storage):
      if ax == RESIDENT:
        leaves.append(st)
      else:          # (L, B, ..., N, ...) from each slot's table-mapped blocks
        leaves.append(torch.stack(
            [kvc.gather_blocks(st, t, ax) for t in tables], dim=1))
    return [self._state_type(*[leaf[layer] for leaf in leaves])
            for layer in range(self.model.cfg.n_layers)]

  def _scatter(self, storage, tables, new_caches) -> List[torch.Tensor]:
    """Write dense per-layer caches back: resident leaves replaced, every
    slot's blocks written into the pool in place (unallocated entries aim at
    the trash block, never read)."""
    out = []
    for i, (ax, st) in enumerate(zip(self._axes, storage)):
      dense = torch.stack([c[i] for c in new_caches])   # (L, B, ...)
      if ax == RESIDENT:
        out.append(dense.to(st.dtype))
        continue
      for b, t in enumerate(tables):
        kvc.scatter_blocks(st, t, dense[:, b], ax)
      out.append(st)
    return out

  def _decode_fused_body(self, cur, storage, tables, lengths):
    """gather -> `Model.decode_step` -> scatter: the dense program."""
    caches = self._gather(storage, tables)
    logits, new_caches = self.model.decode_step(cur, caches, lengths)
    return logits, self._scatter(storage, tables, new_caches)

  def _decode_native_body(self, cur, storage, tables, lengths):
    """The block-table-native program: the kernels read the pools in place
    through `tables`; only this step's rows are written."""
    res = [st if ax == RESIDENT else None
           for ax, st in zip(self._axes, storage)]
    pools = [None if ax == RESIDENT else st
             for ax, st in zip(self._axes, storage)]
    logits, res, pools = self.model.decode_step_paged(cur, res, pools, tables,
                                                      lengths)
    return logits, [r if ax == RESIDENT else p
                    for ax, r, p in zip(self._axes, res, pools)]

  # -- admission / lifetime --------------------------------------------------
  def fits(self, total_len: int, prompt_len: int = 0) -> bool:
    return self._peak_blocks(total_len, prompt_len) <= self.num_blocks

  def _peak_blocks(self, total_len: int, prompt_len: int = 0) -> int:
    """Worst-case simultaneously-held blocks over a solo request's life,
    accounting for ring-reuse; admission transiently holds the full prompt
    extent, hence the `prompt_len` floor."""
    mgr = self.manager
    pol = mgr.policy
    pinned = -(-pol.pinned_tokens() // self.block)
    start = max(prompt_len, 1)
    peak = mgr.blocks_for(start)
    for n in range(start + 1, total_len + 1):
      freed = max(pol.dead_below(n - 1) // self.block - pinned, 0)
      peak = max(peak, mgr.blocks_for(n) - freed)
    return peak

  def can_admit(self, prompt_len: int, total_len: Optional[int] = None
                ) -> bool:
    need = self.manager.blocks_for(prompt_len)
    if total_len is not None:
      # one block of growth headroom, capped at the request's true worst
      # case so admission can never become impossible
      need = min(need + 1, self.manager.blocks_for(total_len))
    return need <= self.manager.free_count

  def admit(self, slot: int, slot_cache, prompt_len: int) -> None:
    """Write a batch-1 prefilled cache (per-layer states) into `slot`: its
    resident rows and its blocks (the whole table row; entries past the
    prompt aim at the trash block)."""
    if not self.manager.admit(slot, prompt_len):
      raise RuntimeError(
          f"block pool exhausted admitting {prompt_len}-token prompt "
          f"(free={self.manager.free_count})")
    table = _to_device(self.manager.tables[slot], self.model.device)
    for i, (ax, st) in enumerate(zip(self._axes, self.storage)):
      one = torch.stack([layer[i][0] for layer in slot_cache])  # (L, ...)
      if ax == RESIDENT:
        st[:, slot].copy_(one)
      else:
        kvc.scatter_blocks(st, table, one, ax)

  def release(self, slot: int) -> None:
    self.manager.release(slot)

  def need_blocks(self, slot: int, target_len: int) -> int:
    return self.manager.need_blocks(slot, target_len)

  def ensure(self, slot: int, target_len: int) -> bool:
    return self.manager.ensure(slot, target_len)

  def reclaim(self, slot: int, length: int) -> int:
    return self.manager.reclaim(slot, length)

  @property
  def free_blocks(self) -> int:
    return self.manager.free_count

  # -- compute ---------------------------------------------------------------
  def decode(self, cur, lengths):
    # peak-traffic snapshot while tables are live; only the block-native
    # path varies per step (the dense figure is a layout constant)
    if self.block_native:
      snap = self.decode_traffic_model()
      if snap["bytes_per_step"] >= self.decode_traffic["bytes_per_step"]:
        self.decode_traffic = snap
    dev = self.model.device
    body = (self._decode_native_body if self.block_native
            else self._decode_fused_body)
    # the (B, nb) tables go to the device once per step, not once per layer
    logits, self.storage = body(
        _to_device(cur, dev), self.storage,
        _to_device(self.manager.tables, dev), _to_device(lengths, dev))
    return logits

  def decode_traffic_model(self) -> dict:
    """Modeled per-step decode device-memory traffic of the paged state.

    `dense` is what the gather->decode->scatter program moves: every slot's
    full table extent materialized as a dense view and written back (2x).
    `block-native` reads only the table-mapped pool blocks in place and
    writes one token row per active slot.
    """
    mgr = self.manager
    tables = mgr.tables
    live = tables != mgr.trash
    mapped_entries = int(live.sum())
    active = int(live.any(axis=1).sum())
    per_block = self._traffic_per_block
    per_row = self._traffic_per_row
    dense = 2 * per_block * self.blocks_per_req * self.max_batch
    reads = per_block * mapped_entries
    writes = per_row * active
    return dict(
        decode_path="block-native" if self.block_native else "dense-gather",
        decode_kernel=mgr.policy.effective_decode_kernel,
        dense_materialized_bytes_per_step=0 if self.block_native else dense,
        dense_gather_scatter_bytes_per_step=dense,
        block_read_bytes_per_step=reads,
        row_write_bytes_per_step=writes,
        bytes_per_step=(reads + writes) if self.block_native else dense)

  def bytes(self, active_slots: int = 0) -> dict:
    """True allocated-block footprint (what paging buys), not capacity."""
    block_bytes = 0
    resident_total = 0
    for ax, leaf in zip(self._axes, self.storage):
      if ax == RESIDENT:
        resident_total += leaf.nbytes
      else:
        block_bytes += leaf.nbytes // (self.num_blocks + 1)
    per_slot_resident = resident_total // max(self.max_batch, 1)
    allocated = self.manager.allocated_count
    tables = self.manager.tables
    refs = collections.Counter(tables[tables != self.manager.trash].tolist())
    shared_blocks = sum(1 for c in refs.values() if c > 1)
    dedup_bytes = sum(c - 1 for c in refs.values() if c > 1) * block_bytes
    return dict(
        kind="paged", block=self.block, num_blocks=self.num_blocks,
        allocated_blocks=allocated, peak_blocks=self.manager.peak_allocated,
        peak_mapped_blocks=self.manager.peak_mapped,
        peak_mapped_bytes=self.manager.peak_mapped * block_bytes,
        block_bytes=block_bytes,
        resident_bytes_per_slot=per_slot_resident,
        shared_blocks=shared_blocks, dedup_bytes=dedup_bytes,
        # the prefix cache (ROADMAP A10) is not ported: nothing is held by
        # an index or forked, as with the reference's cache turned off
        prefix_index_blocks=0, forked_blocks=0,
        total_bytes=(allocated * block_bytes
                     + active_slots * per_slot_resident),
        capacity_bytes=(self.num_blocks * block_bytes
                        + self.max_batch * per_slot_resident))

  def __repr__(self) -> str:
    return (f"PagedLayout(block={self.block}, num_blocks={self.num_blocks}, "
            f"free={self.free_blocks})")
