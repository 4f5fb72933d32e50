"""K3's split-K over the sequence on the CPU: the split picker and the plain
versions of its two steps against the one-pass plain K3 and the reference.

  - `pq_decode_paged_split` cuts every capacity into whole 64-token chunks
    that start below it, within one wave of the SMs (a split block holds
    both codebooks and fits once per SM) and the grid's limits;
  - the plain partials merged by the plain merge equal the one-pass plain K3
    (`pq_decode_attention_paged_plain`) and the reference's
    `pq_decode_attention_paged_kernel(interpret=True)` within 1e-6 (f32, the
    same inputs, sums in another order), for uint8 (K = 16) and int16
    (K = 512) index pools read through shuffled tables whose entries past
    each row's length point at the trash page, at lengths 0, 1, a chunk - 1,
    a chunk, a chunk + 1 and the capacity;
  - an empty row gives out 0, max -1e30, denom 0; a chunk with no token below
    the length is the empty partial (0, -1e30, 0);
  - the step wrappers take the plain versions on CPU tensors, uncounted.

The CUDA legs (each step against its plain version on the card, two calls
bit-equal) are in `test_torch_cuda_kernels.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pq_decode as j_pqd
from repro_torch.kernels import pq_decode as t_pqd

TOL = 1e-6
SPLIT_NS = sorted(set(range(1, 300)) | set(range(300, 32769, 97))
                  | {511, 512, 513, 1023, 1024, 1025, 1040, 16384, 32767,
                     32768})


@pytest.mark.parametrize("bh", [1, 2, 16, 17, 132, 133, 256])
def test_pq_decode_paged_split_cuts_every_capacity(bh):
  sms = 132
  for n in SPLIT_NS:
    s, chunk = t_pqd.pq_decode_paged_split(bh, n, sms)
    tiles = -(-n // t_pqd.PQ_TILE)
    assert 1 <= s <= min(tiles, max(1, sms // bh)), (bh, n, s)
    assert chunk % t_pqd.PQ_TILE == 0 and chunk > 0, (bh, n, chunk)
    # chunks [i chunk, min((i + 1) chunk, n)) cover [0, n) once
    assert (s - 1) * chunk < n <= s * chunk, (bh, n, s, chunk)
    assert bh * s <= max(sms, bh) and s <= 65535
  # the engine's shape: 16 rows of 1024 body tokens in 8 chunks of 2 tiles
  assert t_pqd.pq_decode_paged_split(16, 1024) == (8, 128)
  assert t_pqd.pq_decode_paged_split(4, 1024) == (16, 64)
  assert t_pqd.pq_decode_paged_split(16, 1024, sms=66) == (4, 256)


def _bf16_values(rng, shape):
  """f32 values that bf16 holds exactly (the codebooks' storage type)."""
  x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
  return x.to(torch.bfloat16).float().numpy()


def _tables(rng, b, nb, blk, pool_blocks, lengths):
  """(B, nb) int32: shuffled pool ids, trash (= pool_blocks) past each
  row's length."""
  tables = rng.permutation(pool_blocks)[:b * nb].reshape(b, nb)
  used = -(-np.asarray(lengths) // blk)
  tables = np.where(np.arange(nb)[None, :] >= used[:, None], pool_blocks,
                    tables)
  return tables.astype(np.int32)


# (H, g, d, m, K, blk, nb, L, index dtype): capacity 192 = three tiles
GEOMETRIES = [(2, 2, 16, 4, 16, 16, 12, 3, np.uint8),
              (2, 3, 16, 8, 512, 16, 12, 2, np.int16)]


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("split", [(3, 64), (2, 128), (1, 192), None])
@pytest.mark.parametrize("lengths", [[0, 1, 63, 192], [64, 65, 127, 0],
                                     [128, 129, 191, 5]])
def test_plain_split_merge_matches_one_pass_and_interpret_kernel(
    geometry, split, lengths):
  h, g, d, m, k, blk, nb, n_layers, idt = geometry
  b = len(lengths)
  rng = np.random.default_rng(11)
  cap, pool_blocks = nb * blk, 2 * b * nb
  lengths = np.asarray(lengths, np.int32)
  tables = _tables(rng, b, nb, blk, pool_blocks, lengths)
  q = rng.normal(size=(b * h, g, d)).astype(np.float32)
  kcb = _bf16_values(rng, (b * h, m, k, d // m))
  vcb = _bf16_values(rng, (b * h, m, k, d // m))
  shape = (pool_blocks + 1, n_layers, h, blk, m)
  kpool = rng.integers(0, k, size=shape).astype(idt)
  vpool = rng.integers(0, k, size=shape).astype(idt)
  layer, scale = n_layers - 1, d ** -0.5
  n_split, chunk = split or t_pqd.pq_decode_paged_split(b * h, cap)
  args = (torch.tensor(q), torch.tensor(kcb).to(torch.bfloat16),
          torch.tensor(vcb).to(torch.bfloat16), torch.tensor(kpool),
          torch.tensor(vpool), torch.tensor(tables), layer,
          torch.tensor(lengths), scale)

  acc, stats = t_pqd.pq_decode_paged_partials_plain(*args, n_split, chunk)
  assert acc.shape == (b * h, n_split, g, d)
  assert stats.shape == (b * h, n_split, 2, g)
  out, st = t_pqd.pq_decode_paged_merge_plain(acc, stats)
  one_out, one_st = t_pqd.pq_decode_attention_paged_plain(*args)
  np.testing.assert_allclose(out.numpy(), one_out.numpy(), atol=TOL, rtol=TOL)
  np.testing.assert_allclose(st.numpy(), one_st.numpy(), atol=TOL, rtol=TOL)
  ref_out, ref_st = j_pqd.pq_decode_attention_paged_kernel(
      jnp.asarray(q), jnp.asarray(kcb), jnp.swapaxes(jnp.asarray(vcb), -1, -2),
      jnp.asarray(kpool), jnp.asarray(vpool),
      jnp.asarray(np.repeat(tables, h, axis=0)),
      jnp.asarray([layer], jnp.int32), jnp.asarray(np.repeat(lengths, h)),
      scale=scale, interpret=True)
  np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=TOL,
                             rtol=TOL)
  np.testing.assert_allclose(st.numpy(), np.asarray(ref_st), atol=TOL,
                             rtol=TOL)
  # an empty row: out 0, the -1e30 / 0 sentinel
  empty = np.repeat(lengths == 0, h)
  assert np.all(out.numpy()[empty] == 0)
  assert np.all(st[:, 0].numpy()[empty] == t_pqd.NEG_INF)
  assert np.all(st[:, 1].numpy()[empty] == 0)
  # a chunk with no token below the length is the empty partial
  ln = torch.tensor(np.repeat(lengths, h))
  past = torch.arange(n_split)[None, :] * chunk >= ln[:, None]
  assert torch.all(stats[:, :, 0][past] == t_pqd.NEG_INF)
  assert torch.all(stats[:, :, 1][past] == 0) and torch.all(acc[past] == 0)
  # the step wrappers take the plain versions on CPU tensors, uncounted
  before = t_pqd.pq_decode_attention_paged.launches
  acc2, stats2 = t_pqd.pq_decode_paged_partials(*args, n_split, chunk)
  assert torch.equal(acc2, acc) and torch.equal(stats2, stats)
  out2, st2 = t_pqd.pq_decode_paged_merge(acc, stats)
  assert torch.equal(out2, out) and torch.equal(st2, st)
  assert t_pqd.pq_decode_attention_paged.launches == before


def test_plain_merge_of_all_empty_partials_is_the_sentinel():
  bh, s, g, d = 3, 4, 2, 8
  acc = torch.zeros(bh, s, g, d)
  stats = torch.stack([torch.full((bh, s, g), t_pqd.NEG_INF),
                       torch.zeros(bh, s, g)], dim=2)
  out, st = t_pqd.pq_decode_paged_merge_plain(acc, stats)
  assert torch.equal(out, torch.zeros(bh, g, d))
  assert torch.all(st[:, 0] == t_pqd.NEG_INF) and torch.all(st[:, 1] == 0)
