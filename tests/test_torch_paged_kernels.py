"""The block-table-native decode path of the port against the reference, on
the CPU: the plain versions of K3 and K4, the block primitives and the paged
decode steps.

Inputs come from a numpy seed and go through the port and through the
reference at reduced size:

  - plain K3 against `pq_decode_attention_paged_kernel(interpret=True)`,
    plain K4 against `paged_flash_decode_kernel(interpret=True)`, over
    shuffled tables with trash entries past each length, `layer = L - 1`,
    ragged lengths including 0 and a full table, uint8 (K=16) and int16
    (K=512) index pools.  Tolerance 1e-5: f32, same inputs, sums in another
    order;
  - `blockify`/`unblockify`/`gather_blocks`/`scatter_blocks` equal to the
    reference's;
  - `pq_cache_paged_step` / `exact_cache_paged_step` against the
    reference's (interpret mode): outputs within 1e-5, the updated pools
    exactly equal outside the trash block (rows that write nothing aim
    there, in an order neither side defines, and nothing reads it).

The CUDA legs (kernel against plain version on the card) are in
`test_torch_cuda_kernels.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kv_cache as j_kvc
from repro.core import pq as j_pq
from repro.kernels import paged_flash_decode as j_pfd
from repro.kernels import pq_decode as j_pqd
from repro_torch.core import kv_cache as t_kvc
from repro_torch.core import pq as t_pq
from repro_torch.kernels import paged_flash_decode as t_pfd
from repro_torch.kernels import pq_decode as t_pqd

ATOL = RTOL = 1e-5


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


# (B, H, g, d, m, K, blk, nb, L, index dtype)
PQ_GEOMETRIES = [(2, 2, 2, 16, 4, 16, 4, 4, 3, np.uint8),
                 (2, 2, 2, 16, 8, 512, 8, 3, 2, np.int16)]


@pytest.mark.parametrize("geometry", PQ_GEOMETRIES)
@pytest.mark.parametrize("lengths", [[0, "full"], [5, 13]])
def test_plain_k3_matches_interpret_kernel(geometry, lengths):
  b, h, g, d, m, k, blk, nb, n_layers, idt = geometry
  rng = np.random.default_rng(1)
  cap, pool_blocks = nb * blk, 3 * nb
  lengths = np.asarray([cap if x == "full" else x for x in lengths], np.int32)
  tables = _tables(rng, b, nb, blk, pool_blocks, lengths)
  q = rng.normal(size=(b * h, g, d)).astype(np.float32)
  kcb = _bf16_values(rng, (b * h, m, k, d // m))
  vcb = _bf16_values(rng, (b * h, m, k, d // m))
  shape = (pool_blocks + 1, n_layers, h, blk, m)
  kpool = rng.integers(0, k, size=shape).astype(idt)
  vpool = rng.integers(0, k, size=shape).astype(idt)
  layer, scale = n_layers - 1, d ** -0.5

  out, stats = t_pqd.pq_decode_attention_paged(
      torch.tensor(q), torch.tensor(kcb).to(torch.bfloat16),
      torch.tensor(vcb).to(torch.bfloat16), torch.tensor(kpool),
      torch.tensor(vpool), torch.tensor(tables), layer,
      torch.tensor(lengths), scale)
  ref_out, ref_stats = j_pqd.pq_decode_attention_paged_kernel(
      jnp.asarray(q), jnp.asarray(kcb), jnp.swapaxes(jnp.asarray(vcb), -1, -2),
      jnp.asarray(kpool), jnp.asarray(vpool),
      jnp.asarray(np.repeat(tables, h, axis=0)),
      jnp.asarray([layer], jnp.int32), jnp.asarray(np.repeat(lengths, h)),
      scale=scale, interpret=True)
  np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL,
                             rtol=RTOL)
  np.testing.assert_allclose(stats.numpy(), np.asarray(ref_stats),
                             atol=ATOL, rtol=RTOL)
  if lengths[0] == 0:
    assert np.all(out[:h].numpy() == 0) and np.all(stats[:h, 1].numpy() == 0)


@pytest.mark.parametrize("lengths", [[0, 24], [23, 7], [1, 17]])
def test_plain_k4_matches_interpret_kernel(lengths):
  b, h, g, d, blk, nb, n_layers = 2, 2, 2, 16, 4, 6, 3
  rng = np.random.default_rng(2)
  pool_blocks = 3 * nb
  lengths = np.asarray(lengths, np.int32)
  tables = _tables(rng, b, nb, blk, pool_blocks, lengths)
  q = rng.normal(size=(b * h, g, d)).astype(np.float32)
  shape = (pool_blocks + 1, n_layers, h, blk, d)
  kpool = rng.normal(size=shape).astype(np.float32)
  vpool = rng.normal(size=shape).astype(np.float32)
  layer, scale = n_layers - 1, d ** -0.5

  out = t_pfd.paged_flash_decode(
      torch.tensor(q), torch.tensor(kpool), torch.tensor(vpool),
      torch.tensor(tables), layer, torch.tensor(lengths), scale)
  ref = j_pfd.paged_flash_decode_kernel(
      jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool),
      jnp.asarray(np.repeat(tables, h, axis=0)),
      jnp.asarray([layer], jnp.int32), jnp.asarray(np.repeat(lengths, h)),
      scale=scale, interpret=True)
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                             rtol=RTOL)
  if lengths[0] == 0:
    assert np.all(out[:h].numpy() == 0)


def test_block_primitives_match_reference():
  rng = np.random.default_rng(3)
  dense = rng.normal(size=(3, 2, 12, 5)).astype(np.float32)   # (L, H, N, D)
  blocks = t_kvc.blockify(torch.tensor(dense), 2, 4)
  np.testing.assert_array_equal(blocks.numpy(),
                                np.asarray(j_kvc.blockify(dense, 2, 4)))
  np.testing.assert_array_equal(t_kvc.unblockify(blocks, 2).numpy(), dense)
  pool = rng.normal(size=(7, 3, 2, 4, 5)).astype(np.float32)
  table = np.asarray([5, 0, 6], np.int32)
  np.testing.assert_array_equal(
      t_kvc.gather_blocks(torch.tensor(pool), torch.tensor(table), 2).numpy(),
      np.asarray(j_kvc.gather_blocks(pool, table, 2)))
  got = t_kvc.scatter_blocks(torch.tensor(pool), torch.tensor(table),
                             torch.tensor(dense), 2)
  np.testing.assert_array_equal(
      got.numpy(), np.asarray(j_kvc.scatter_blocks(jnp.asarray(pool), table,
                                                   dense, 2)))


def _pq_step_inputs(rng, idt, k):
  b, h, hq, d, m, blk, n_layers = 3, 2, 4, 16, 4, 4, 3
  s0, r, body = 4, 8, 16
  nb = body // blk
  pool_blocks = 4 * nb
  # before the step: warming up (in the sink), filling the ring, evicting
  lengths = np.asarray([2, 9, 19], np.int32)
  body_after = np.clip(lengths + 1 - s0 - r, 0, body)
  tables = _tables(rng, b, nb, blk, pool_blocks, np.maximum(body_after, 1))
  inp = dict(
      sink_k=rng.normal(size=(b, h, s0, d)).astype(np.float32),
      sink_v=rng.normal(size=(b, h, s0, d)).astype(np.float32),
      recent_k=rng.normal(size=(b, h, r, d)).astype(np.float32),
      recent_v=rng.normal(size=(b, h, r, d)).astype(np.float32),
      kcb=_bf16_values(rng, (b, h, 1, m, k, d // m)),
      vcb=_bf16_values(rng, (b, h, 1, m, k, d // m)),
      kpool=rng.integers(0, k, size=(pool_blocks + 1, n_layers, h, blk, m)
                         ).astype(idt),
      vpool=rng.integers(0, k, size=(pool_blocks + 1, n_layers, h, blk, m)
                         ).astype(idt),
      tables=tables, q=rng.normal(size=(b, hq, d)).astype(np.float32),
      k_new=rng.normal(size=(b, h, d)).astype(np.float32),
      v_new=rng.normal(size=(b, h, d)).astype(np.float32), lengths=lengths)
  geo = dict(sink=s0, recent=r, body_capacity=body, n_windows=1)
  return inp, geo, m, n_layers


@pytest.mark.parametrize("idt,k", [(np.uint8, 16), (np.int16, 512)])
def test_pq_cache_paged_step_matches_reference(idt, k):
  rng = np.random.default_rng(4)
  inp, geo, m, n_layers = _pq_step_inputs(rng, idt, k)
  layer, scale = n_layers - 1, 16 ** -0.5
  t_cfg = t_kvc.PQCacheConfig(pq=t_pq.PQConfig(m=m, k=k), **geo)
  j_cfg = j_kvc.PQCacheConfig(pq=j_pq.PQConfig(m=m, k=k), **geo)
  t = {n: torch.tensor(v) for n, v in inp.items()}
  got = t_kvc.pq_cache_paged_step(
      t["sink_k"], t["sink_v"], t["recent_k"], t["recent_v"],
      t["kcb"].to(torch.bfloat16), t["vcb"].to(torch.bfloat16),
      t["kpool"].clone(), t["vpool"].clone(), layer, t["tables"], t["q"],
      t["k_new"], t["v_new"], t["lengths"], t_cfg, scale)
  j = {n: jnp.asarray(v) for n, v in inp.items()}
  ref = j_kvc.pq_cache_paged_step(
      j["sink_k"], j["sink_v"], j["recent_k"], j["recent_v"],
      j["kcb"].astype(jnp.bfloat16), j["vcb"].astype(jnp.bfloat16),
      j["kpool"], j["vpool"], jnp.asarray(layer, jnp.int32), j["tables"],
      j["q"], j["k_new"], j["v_new"], j["lengths"], j_cfg, scale,
      interpret=True)
  for a, e in zip(got[:5], ref[:5]):          # out and the four rings
    np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=ATOL,
                               rtol=RTOL)
  trash = inp["kpool"].shape[0] - 1
  for a, e in zip(got[5:], ref[5:]):          # the index pools
    assert str(a.dtype) == f"torch.{np.asarray(e).dtype}"
    np.testing.assert_array_equal(a.numpy()[:trash], np.asarray(e)[:trash])
  # the one evicting row wrote its encoded indices into its mapped block
  assert not np.array_equal(got[5].numpy()[:trash], inp["kpool"][:trash])


def test_exact_cache_paged_step_matches_reference():
  rng = np.random.default_rng(5)
  b, h, hq, d, blk, nb, n_layers = 3, 2, 4, 16, 4, 5, 3
  pool_blocks = 3 * nb
  lengths = np.asarray([0, 7, 19], np.int32)
  tables = _tables(rng, b, nb, blk, pool_blocks, lengths + 1)
  kpool = rng.normal(size=(pool_blocks + 1, n_layers, h, blk, d)
                     ).astype(np.float32)
  vpool = rng.normal(size=kpool.shape).astype(np.float32)
  q = rng.normal(size=(b, hq, d)).astype(np.float32)
  k_new = rng.normal(size=(b, h, d)).astype(np.float32)
  v_new = rng.normal(size=(b, h, d)).astype(np.float32)
  layer, scale = n_layers - 1, d ** -0.5
  out, kp, vp = t_kvc.exact_cache_paged_step(
      torch.tensor(kpool), torch.tensor(vpool), layer, torch.tensor(tables),
      torch.tensor(q), torch.tensor(k_new), torch.tensor(v_new),
      torch.tensor(lengths), scale)
  r_out, r_kp, r_vp = j_kvc.exact_cache_paged_step(
      jnp.asarray(kpool), jnp.asarray(vpool), jnp.asarray(layer, jnp.int32),
      jnp.asarray(tables), jnp.asarray(q), jnp.asarray(k_new),
      jnp.asarray(v_new), jnp.asarray(lengths), scale, interpret=True)
  np.testing.assert_allclose(out.numpy(), np.asarray(r_out), atol=ATOL,
                             rtol=RTOL)
  np.testing.assert_array_equal(kp.numpy()[:pool_blocks],
                                np.asarray(r_kp)[:pool_blocks])
  np.testing.assert_array_equal(vp.numpy()[:pool_blocks],
                                np.asarray(r_vp)[:pool_blocks])
