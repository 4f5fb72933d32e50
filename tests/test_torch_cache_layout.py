"""The port's paged layout against the reference's, on the CPU.

  - `BlockAllocator` / `BlockTableManager` driven by one seeded random
    admit / grow / reclaim / release trace beside the reference's: tables,
    free and allocated counts, peaks and return values exactly equal after
    every operation (a ring-reusing stub codec exercises `reclaim`, which no
    ported policy uses);
  - `PagedLayout.bytes()` and `decode_traffic_model()` equal to the
    reference's after every step of one engine trace, for `exact` and `pq`;
  - the block-table-native program: the port layout's `_decode_native_body`
    on the admitted storage against the reference's `PagedLayout` decoding
    under `pallas-interpret` (its block-native program, with the paged
    kernels in interpret mode).  The block-native program is reached on the
    CPU only this way, as in the reference.  Both programs start from the
    reference's admitted storage, copied into the port's layout: the test
    holds the decode program, not the prefill (a prefill k-means can meet an
    f32 distance tie, ROADMAP C6).  Logits within 1e-5; the pools after each
    step exactly equal outside the trash block, resident leaves within 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import cache_layout as j_layout
from repro_torch.core import cache_layout as t_layout
from torch_parity import engine_pair, random_trace

ATOL = RTOL = 1e-5


class _RingCodec:
  """Stub codec: 4 pinned sink tokens, everything older than a 24-token
  window dead (the shape of a streaming window)."""

  def token_extent(self, length):
    return min(length, 96)

  def pinned_tokens(self):
    return 4

  def dead_below(self, length):
    return max(length - 24, 0)


def _manager_state(m):
  return (m.tables.tolist(), m.free_count, m.allocated_count,
          m.peak_allocated, m.peak_mapped, [m.high_water(s) for s in range(4)])


def test_block_table_manager_matches_reference_on_random_trace():
  num_blocks, per_req, slots, block = 14, 12, 4, 8
  ref = j_layout.BlockTableManager(num_blocks, per_req, slots, block,
                                   _RingCodec())
  got = t_layout.BlockTableManager(num_blocks, per_req, slots, block,
                                   _RingCodec())
  rng = np.random.default_rng(11)
  lengths = [0] * slots
  for _ in range(400):
    slot = int(rng.integers(slots))
    op = rng.choice(["admit", "grow", "reclaim", "release"])
    if op == "admit" and lengths[slot] == 0:
      n = int(rng.integers(1, 40))
      out = (ref.admit(slot, n), got.admit(slot, n))
      if out[0]:
        lengths[slot] = n
    elif op == "grow" and lengths[slot]:
      n = lengths[slot] + int(rng.integers(1, 9))
      out = (ref.ensure(slot, n), got.ensure(slot, n))
      if out[0]:
        lengths[slot] = n
    elif op == "reclaim" and lengths[slot]:
      out = (ref.reclaim(slot, lengths[slot]),
             got.reclaim(slot, lengths[slot]))
    elif op == "release":
      out = (ref.release(slot), got.release(slot))
      lengths[slot] = 0
    else:
      continue
    assert out[0] == out[1], op
    assert _manager_state(got) == _manager_state(ref), op
    got.check_invariants()
  assert ref.peak_allocated == got.peak_allocated > 0


def _traffic(model):
  return {k: v for k, v in model.items() if k != "decode_kernel"}


@pytest.mark.parametrize("policy", ["exact", "pq"])
def test_layout_bytes_and_traffic_match_reference(policy):
  je, te = engine_pair(policy, "paged", "paged")
  for p, mx in random_trace(3, n=5):
    je.submit(p, mx)
    te.submit(p, mx)
  assert te.layout.bytes() == je.layout.bytes()
  while je.has_work:
    je.step()
    te.step()
    assert te.active_count == je.active_count
    assert (te.layout.bytes(active_slots=te.active_count)
            == je.layout.bytes(active_slots=je.active_count))
    got, ref = (te.layout.decode_traffic_model(),
                je.layout.decode_traffic_model())
    assert _traffic(got) == _traffic(ref)
    assert (got["decode_kernel"], ref["decode_kernel"]) == ("torch", "xla")
  assert not te.has_work


def _leaves_equal(t_storage, j_storage, axes, trash):
  for ax, got, ref in zip(axes, t_storage,
                          jax.tree_util.tree_leaves(j_storage)):
    ref = np.asarray(ref.astype(np.float32) if ref.dtype == "bfloat16"
                     else ref)
    got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    if ax == t_layout.RESIDENT:
      np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    elif got.dtype.kind in "iu":
      np.testing.assert_array_equal(got[:trash], ref[:trash])
    else:
      np.testing.assert_allclose(got[:trash], ref[:trash], atol=ATOL,
                                 rtol=RTOL)


@pytest.mark.parametrize("policy", ["pq", "exact"])
def test_native_body_matches_reference_block_native(policy):
  je, te = engine_pair(policy, "paged", "paged", j_kernel="pallas-interpret")
  assert je.layout.block_native and not te.layout.block_native
  for p, mx in random_trace(4, n=3):
    je.submit(p, mx)
    te.submit(p, mx)
  je._admit()
  te._admit()
  layout = te.layout
  trash = layout.num_blocks
  for got, ref in zip(layout.storage,
                      jax.tree_util.tree_leaves(je.layout.storage)):
    got.copy_(torch.tensor(np.asarray(ref.astype(np.float32)
                                      if ref.dtype == "bfloat16" else ref)))
  for _ in range(3):
    je._ensure_blocks()
    te._ensure_blocks()
    np.testing.assert_array_equal(layout.manager.tables,
                                  je.layout.manager.tables)
    ref = np.asarray(je.layout.decode(je.params, je._cur, je._lengths))
    got, layout.storage = layout._decode_native_body(
        torch.from_numpy(te._cur), layout.storage,
        torch.from_numpy(layout.manager.tables), torch.from_numpy(te._lengths))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    _leaves_equal(layout.storage, je.layout.storage, layout._axes, trash)
    # teacher-forced on the reference's tokens, all slots active
    nxt = ref.argmax(-1).astype(np.int32)
    for eng in (je, te):
      eng._cur[:] = nxt
      eng._lengths[:] += 1
