"""K5's split over the pages, its plain steps, on the CPU.

On the card K5 runs a split kernel over (row, chunk of the pages) and then
K2's merge; these tests hold the plain versions of those two steps:

  - `packed_paged_flash_decode_partials_plain` then `flash_decode_merge_plain`
    equal the one-pass plain K5 (`packed_paged_flash_decode_plain`, itself
    held to the reference's interpret kernel in `test_torch_packed_cache.py`)
    and the reference's `packed_paged_flash_decode_kernel(interpret=True)`,
    within 1e-6 and 1e-5 (f32, the same values summed in another order), for
    bits 4, 5 and 8, lengths 0, 1, one chunk - 1, one chunk, one chunk + 1
    and full, shuffled tables with trash entries past each length, and
    splits of 1, 2 and 3 chunks;
  - a chunk at or past a row's length gives (0, -inf, 0), and a row of
    length 0 merges to 0;
  - the step wrapper takes the plain partials for CPU tensors and counts no
    launch; K5's split is K2's rule on the pool's capacity nb * blk.

The CUDA legs (the split kernel and the merge against these plain versions,
two calls bit-equal, K5 within 1e-4 of K4) are in `test_torch_cuda_kernels.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import packing as j_pk
from repro.kernels import paged_flash_decode as j_pfd
from repro_torch.kernels import paged_flash_decode as t_pfd

B, H, G, D, BLK, NB, L = 2, 2, 2, 16, 4, 6, 3
CAP = NB * BLK


def _inputs(bits, lengths, seed):
  rng = np.random.default_rng(seed)
  pool_blocks = 3 * NB
  tables = rng.permutation(pool_blocks)[:B * NB].reshape(B, NB)
  used = -(-np.asarray(lengths) // BLK)
  tables = np.where(np.arange(NB)[None, :] >= used[:, None], pool_blocks,
                    tables).astype(np.int32)
  q = rng.normal(size=(B * H, G, D)).astype(np.float32)
  pools = []
  for _ in range(2):
    x = rng.normal(scale=1.5, size=(pool_blocks + 1, L, H, BLK, D)).astype(
        np.float32)
    pools += [np.asarray(a) for a in j_pk.pack_rows(
        jnp.asarray(x), bits=bits, group=j_pk.group_size(D))]
  return q, pools, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("bits", [4, 5, 8])
@pytest.mark.parametrize("n_split,chunk", [(1, CAP), (2, 12), (3, 8)])
@pytest.mark.parametrize("lengths", [[0, CAP], [1, 7], [8, 9], [12, 13],
                                     [CAP - 1, 5]])
def test_plain_partials_and_merge_match_one_pass(bits, n_split, chunk,
                                                 lengths):
  q, pools, tables, ln = _inputs(bits, lengths, seed=bits + chunk)
  layer, scale = L - 1, D ** -0.5
  tq, tt, tl = torch.tensor(q), torch.tensor(tables), torch.tensor(ln)
  tp = [torch.tensor(p) for p in pools]
  acc, stats = t_pfd.packed_paged_flash_decode_partials_plain(
      tq, *tp, tt, layer, tl, scale, bits, n_split, chunk)
  assert tuple(acc.shape) == (B * H, n_split, G, D)
  assert tuple(stats.shape) == (B * H, n_split, 2, G)
  # chunks at or past a row's length: (0, -inf, 0)
  rows = np.repeat(ln, H)
  for s in range(n_split):
    past = torch.tensor(rows <= s * chunk)
    assert torch.all(acc[past, s] == 0)
    assert torch.all(stats[past, s, 0] == float("-inf"))
    assert torch.all(stats[past, s, 1] == 0)
  merged = t_pfd.flash_decode_merge_plain(acc, stats)
  one_pass = t_pfd.packed_paged_flash_decode_plain(tq, *tp, tt, layer, tl,
                                                   scale, bits)
  np.testing.assert_allclose(merged.numpy(), one_pass.numpy(), atol=1e-6,
                             rtol=1e-6)
  ref = j_pfd.packed_paged_flash_decode_kernel(
      jnp.asarray(q), *[jnp.asarray(p) for p in pools],
      jnp.asarray(np.repeat(tables, H, axis=0)),
      jnp.asarray([layer], jnp.int32), jnp.asarray(rows),
      scale=scale, bits=bits, interpret=True)
  np.testing.assert_allclose(merged.numpy(), np.asarray(ref), atol=1e-5,
                             rtol=1e-5)
  assert torch.all(merged[torch.tensor(rows == 0)] == 0)


def test_step_wrapper_takes_plain_partials_on_cpu():
  q, pools, tables, ln = _inputs(4, [5, CAP], seed=0)
  args = (torch.tensor(q), *[torch.tensor(p) for p in pools],
          torch.tensor(tables), L - 1, torch.tensor(ln), D ** -0.5, 4)
  before = t_pfd.packed_paged_flash_decode.launches
  got = t_pfd.packed_paged_flash_decode_partials(*args, 2, 12)
  want = t_pfd.packed_paged_flash_decode_partials_plain(*args, 2, 12)
  assert t_pfd.packed_paged_flash_decode.launches == before
  for a, w in zip(got, want):
    np.testing.assert_array_equal(a.numpy(), w.numpy())
  with pytest.raises(ValueError, match="code rows"):
    t_pfd.packed_paged_flash_decode_partials(*args[:-1], 5, 2, 12)


@pytest.mark.parametrize("bh,nb,blk", [(16, 66, 16), (4, 64, 16), (1, 6, 4),
                                       (64, 128, 16)])
def test_k5_split_is_k2_rule_on_the_pool_capacity(bh, nb, blk):
  n_split, chunk = t_pfd.flash_decode_split(bh, nb * blk, 132)
  assert chunk % t_pfd.DECODE_TILE == 0
  assert (n_split - 1) * chunk < nb * blk <= n_split * chunk
  if (bh, nb, blk) == (16, 66, 16):
    # the engine's q4 step: 17 chunks of one tile, 272 blocks
    assert (n_split, chunk) == (17, 64)
