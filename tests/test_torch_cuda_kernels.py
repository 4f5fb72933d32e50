"""Each CUDA kernel against its plain PyTorch version, on the card.

K3 is also held to K1 on the gathered dense view within 1e-4, the tolerance
each meets against the plain version: K3 splits the sequence over blocks
and merges the partials, so its sums run in another order than K1's single
pass.  K4 is held to K2 on that view within 1e-4 for the same reason (K2
splits, K4 does not).  K2 and K3 are held bit for bit to themselves over
two calls (their merges are deterministic), and each of their two steps to
its plain version.  K5 is held to K4 run on the f32 pools its plain dequant
produces within 1e-4 (K5 splits the pages over blocks and merges through
K2's merge, K4 does not), and bit for bit to itself over two calls, its
split step to its plain version; K6 and K8 to their plain versions exactly.
B0 (the k-means update) is held to its plain one-hot version element by
element within `kmeans_update.kmeans_update_tolerance` (1e-5 of the
cluster's mean |w x| plus 1e-7: both sum the same f32 terms in other
orders), its frozen clusters to the old centroid bit for bit, and to itself
over two calls.  K7 (flash attention, the prefill's)
is held to its plain version element by element within
`flash_attention.kernel_error_bound`: for bf16 inputs 2^-8 x the plain
attention of |v| (the kernel rounds P to bf16 before the PV product) +
2^-7 |plain| (both outputs round to bf16) + 1e-5, at most 3e-2 (the bf16
limit of `tests/test_kernels.py`), for f32 1e-5 (FMA on the
CUDA cores, no TF32; the sums in another order).

Marked `cuda`: without a card every test skips.  This file imports no JAX,
so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_kernels.py

Tolerance 1e-4: f32 accumulation in another order over the same bf16 (or
f32) inputs.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import kv_cache as t_kvc
from repro_torch.core import pq as t_pq
from repro_torch.kernels import flash_attention as t_k7
from repro_torch.kernels import kmeans_assign as t_k6
from repro_torch.kernels import kmeans_update as t_b0
from repro_torch.kernels import packing as t_pk
from repro_torch.kernels import paged_flash_decode as t_pfd
from repro_torch.kernels import pq_decode as t_pqd

CUDA_ATOL = 1e-4


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (sm_90a); runs on the chip")
  return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [
    (4, 2, 16, 4, 16, 64, torch.uint8),       # reduced: m=4, K=16, dsub=4
    (16, 8, 64, 32, 512, 1024, torch.int16),  # full tinyllama: dsub=2
    (16, 8, 64, 32, 512, 1024, torch.int32),
])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_cuda_pq_decode_matches_plain(cuda_device, geometry, q_dtype):
  bh, g, d, m, k, n, idx_dtype = geometry
  dev = cuda_device
  gen = torch.Generator(device=dev).manual_seed(5)
  q = torch.randn(bh, g, d, generator=gen, device=dev).to(q_dtype)
  kcb, vcb = (torch.randn(bh, m, k, d // m, generator=gen, device=dev
                          ).to(torch.bfloat16) for _ in range(2))
  kidx, vidx = (torch.randint(0, k, (bh, n, m), generator=gen, device=dev
                              ).to(idx_dtype) for _ in range(2))
  ln = torch.randint(0, n + 1, (bh,), generator=gen, device=dev,
                     dtype=torch.int32)
  ln[0], ln[-1] = 0, n
  before = t_pqd.pq_decode_attention.launches
  out, stats = t_pqd.pq_decode_attention(q, kcb, vcb, kidx, vidx, ln,
                                         d ** -0.5)
  plain = t_pqd.pq_decode_attention_plain(q, kcb, vcb, kidx, vidx, ln,
                                          d ** -0.5)
  torch.cuda.synchronize()
  assert t_pqd.pq_decode_attention.launches == before + 1
  torch.testing.assert_close(out, plain[0], atol=CUDA_ATOL, rtol=CUDA_ATOL)
  torch.testing.assert_close(stats, plain[1], atol=CUDA_ATOL, rtol=CUDA_ATOL)
  assert torch.all(out[0] == 0) and torch.all(stats[0, 1] == 0)


def _decode_lengths(bh, n, chunk):
  """Length vectors of bh rows that together hold 0, 1, 63, 64, 65, one
  chunk - 1, one chunk, one chunk + 1 and n (each clamped to n)."""
  special = [min(x, n) for x in (0, 1, 63, 64, 65, chunk - 1, chunk,
                                 chunk + 1, n)]
  rows = [special[i:i + bh] for i in range(0, len(special), bh)]
  return [(r * bh)[:bh] for r in rows]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d", [(8, 64), (2, 16)])
@pytest.mark.parametrize("bh,n", [(16, 1040), (1, 1000), (64, 333),
                                  (1, 4100), (16, 100), (1, 20000)])
def test_cuda_flash_decode_matches_plain(cuda_device, dtype, g, d, bh, n):
  dev = cuda_device
  gen = torch.Generator(device=dev).manual_seed(6)
  n_split, chunk = t_pfd.flash_decode_split(
      bh, n, torch.cuda.get_device_properties(dev).multi_processor_count)
  q = torch.randn(bh, g, d, generator=gen, device=dev).to(dtype)
  k, v = (torch.randn(bh, n, d, generator=gen, device=dev).to(dtype)
          for _ in range(2))
  ln = torch.randint(0, n + 1, (bh,), generator=gen, device=dev,
                     dtype=torch.int32)
  ln[0], ln[-1] = 0, n
  cases = [ln] + [torch.tensor(x, dtype=torch.int32, device=dev)
                  for x in _decode_lengths(bh, n, chunk)]
  for ln in cases:
    before = t_pfd.flash_decode.launches
    out = t_pfd.flash_decode(q, k, v, ln, d ** -0.5)
    plain = t_pfd.flash_decode_plain(q, k, v, ln, d ** -0.5)
    torch.cuda.synchronize()
    assert t_pfd.flash_decode.launches == before + 1
    torch.testing.assert_close(out, plain, atol=CUDA_ATOL, rtol=CUDA_ATOL)
    assert torch.all(out[ln == 0] == 0)
    assert torch.equal(out, t_pfd.flash_decode(q, k, v, ln, d ** -0.5)), (
        "two K2 calls differ")
  # each step against its plain version: the split kernel's partials, and
  # the merge kernel on those partials against the plain merge
  acc, stats = t_pfd.flash_decode_partials(q, k, v, cases[0], d ** -0.5,
                                           n_split, chunk)
  p_acc, p_stats = t_pfd.flash_decode_partials_plain(
      q, k, v, cases[0], d ** -0.5, n_split, chunk)
  torch.testing.assert_close(acc, p_acc, atol=CUDA_ATOL, rtol=CUDA_ATOL)
  torch.testing.assert_close(stats, p_stats, atol=CUDA_ATOL, rtol=CUDA_ATOL)
  torch.testing.assert_close(t_pfd.flash_decode_merge(acc, stats),
                             t_pfd.flash_decode_merge_plain(acc, stats),
                             atol=CUDA_ATOL, rtol=CUDA_ATOL)


def _paged_inputs(gen, dev, b, nb, blk, pool_blocks, lengths):
  """Tables (B, nb): a seeded permutation of pool ids, with the trash block
  `pool_blocks` in every entry past a row's length."""
  perm = torch.randperm(pool_blocks, generator=gen, device=dev)[:b * nb]
  tables = perm.reshape(b, nb).to(torch.int32)
  ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
  used = -(-ln.long() // blk)
  past = torch.arange(nb, device=dev)[None, :] >= used[:, None]
  return tables.masked_fill(past, pool_blocks), ln


# (B, H, g, d, m, K, blk, nb, L, layer, index dtype): the paged serve path's
# full-width shapes (tinyllama-1.1b, K = 512 int16 and K = 256 uint8) and a
# reduced one with other strides
PAGED_GEOMETRIES = [
    (4, 4, 8, 64, 32, 512, 16, 64, 22, 21, torch.int16),
    (4, 4, 8, 64, 32, 256, 16, 64, 22, 7, torch.uint8),
    (2, 2, 2, 16, 4, 16, 4, 6, 3, 1, torch.uint8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", PAGED_GEOMETRIES)
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_cuda_pq_decode_paged_matches_plain_and_k1(cuda_device, geometry,
                                                   q_dtype):
  b, h, g, d, m, k, blk, nb, n_layers, layer, idx_dtype = geometry
  dev = cuda_device
  gen = torch.Generator(device=dev).manual_seed(7)
  pool_blocks = 4 * nb
  cap = nb * blk
  lengths = ([0, cap, cap // 2 + 3, 1] * b)[:b]
  tables, ln = _paged_inputs(gen, dev, b, nb, blk, pool_blocks, lengths)
  q = torch.randn(b * h, g, d, generator=gen, device=dev).to(q_dtype)
  kcb, vcb = (torch.randn(b * h, m, k, d // m, generator=gen, device=dev
                          ).to(torch.bfloat16) for _ in range(2))
  shape = (pool_blocks + 1, n_layers, h, blk, m)
  kpool, vpool = (torch.randint(0, k, shape, generator=gen, device=dev
                                ).to(idx_dtype) for _ in range(2))
  before = t_pqd.pq_decode_attention_paged.launches
  out, stats = t_pqd.pq_decode_attention_paged(
      q, kcb, vcb, kpool, vpool, tables, layer, ln, d ** -0.5)
  plain = t_pqd.pq_decode_attention_paged_plain(
      q, kcb, vcb, kpool, vpool, tables, layer, ln, d ** -0.5)
  torch.cuda.synchronize()
  assert t_pqd.pq_decode_attention_paged.launches == before + 1
  torch.testing.assert_close(out, plain[0], atol=CUDA_ATOL, rtol=CUDA_ATOL)
  torch.testing.assert_close(stats, plain[1], atol=CUDA_ATOL, rtol=CUDA_ATOL)
  assert torch.all(out[:h] == 0) and torch.all(stats[:h, 1] == 0)
  assert torch.all(stats[:h, 0] == t_pqd.NEG_INF)
  # K1 on the gathered dense view: the same function, its sums in one pass
  dense = [p[:, layer][tables.long()].permute(0, 2, 1, 3, 4).reshape(
      b * h, cap, m).contiguous() for p in (kpool, vpool)]
  out1, stats1 = t_pqd.pq_decode_attention(
      q, kcb, vcb, dense[0], dense[1], ln.repeat_interleave(h), d ** -0.5)
  torch.testing.assert_close(out, out1, atol=CUDA_ATOL, rtol=CUDA_ATOL)
  torch.testing.assert_close(stats, stats1, atol=CUDA_ATOL, rtol=CUDA_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", PAGED_GEOMETRIES)
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_cuda_pq_decode_paged_steps_and_two_calls(cuda_device, geometry,
                                                  q_dtype):
  b, h, g, d, m, k, blk, nb, n_layers, layer, idx_dtype = geometry
  dev = cuda_device
  gen = torch.Generator(device=dev).manual_seed(13)
  pool_blocks = 4 * nb
  cap = nb * blk
  n_split, chunk = t_pqd.pq_decode_paged_split(
      b * h, cap, torch.cuda.get_device_properties(dev).multi_processor_count)
  q = torch.randn(b * h, g, d, generator=gen, device=dev).to(q_dtype)
  kcb, vcb = (torch.randn(b * h, m, k, d // m, generator=gen, device=dev
                          ).to(torch.bfloat16) for _ in range(2))
  shape = (pool_blocks + 1, n_layers, h, blk, m)
  kpool, vpool = (torch.randint(0, k, shape, generator=gen, device=dev
                                ).to(idx_dtype) for _ in range(2))
  # rows on a chunk boundary and one token either side of it, empty, full
  special = [min(x, cap) for x in (chunk - 1, chunk, chunk + 1, 0, 1, cap,
                                   2 * chunk - 1, 2 * chunk + 1)]
  for i in range(0, len(special), b):
    lengths = (special[i:i + b] * b)[:b]
    tables, ln = _paged_inputs(gen, dev, b, nb, blk, pool_blocks, lengths)
    args = (q, kcb, vcb, kpool, vpool, tables, layer, ln, d ** -0.5)
    out, stats = t_pqd.pq_decode_attention_paged(*args)
    again = t_pqd.pq_decode_attention_paged(*args)
    plain = t_pqd.pq_decode_attention_paged_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again[0]) and torch.equal(stats, again[1]), (
        "two K3 calls differ")
    torch.testing.assert_close(out, plain[0], atol=CUDA_ATOL, rtol=CUDA_ATOL)
    torch.testing.assert_close(stats, plain[1], atol=CUDA_ATOL,
                               rtol=CUDA_ATOL)
    # each step against its plain version: the split kernel's partials, and
    # the merge kernel on those partials against the plain merge
    acc, pst = t_pqd.pq_decode_paged_partials(*args, n_split, chunk)
    p_acc, p_pst = t_pqd.pq_decode_paged_partials_plain(*args, n_split,
                                                        chunk)
    torch.testing.assert_close(acc, p_acc, atol=CUDA_ATOL, rtol=CUDA_ATOL)
    torch.testing.assert_close(pst, p_pst, atol=CUDA_ATOL, rtol=CUDA_ATOL)
    m_out, m_st = t_pqd.pq_decode_paged_merge(acc, pst)
    w_out, w_st = t_pqd.pq_decode_paged_merge_plain(acc, pst)
    torch.testing.assert_close(m_out, w_out, atol=CUDA_ATOL, rtol=CUDA_ATOL)
    torch.testing.assert_close(m_st, w_st, atol=CUDA_ATOL, rtol=CUDA_ATOL)
    assert torch.equal(m_out, out) and torch.equal(m_st, stats)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [gm[:10] for gm in PAGED_GEOMETRIES[::2]])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_paged_flash_decode_matches_plain_and_k2(cuda_device, geometry,
                                                      dtype):
  b, h, g, d, _, _, blk, nb, n_layers, layer = geometry
  dev = cuda_device
  gen = torch.Generator(device=dev).manual_seed(8)
  pool_blocks = 4 * nb
  cap = nb * blk
  lengths = ([cap, 0, 1, cap - blk + 5] * b)[:b]
  tables, ln = _paged_inputs(gen, dev, b, nb, blk, pool_blocks, lengths)
  q = torch.randn(b * h, g, d, generator=gen, device=dev).to(dtype)
  shape = (pool_blocks + 1, n_layers, h, blk, d)
  kpool, vpool = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for _ in range(2))
  before = t_pfd.paged_flash_decode.launches
  out = t_pfd.paged_flash_decode(q, kpool, vpool, tables, layer, ln,
                                 d ** -0.5)
  plain = t_pfd.paged_flash_decode_plain(q, kpool, vpool, tables, layer, ln,
                                         d ** -0.5)
  torch.cuda.synchronize()
  assert t_pfd.paged_flash_decode.launches == before + 1
  torch.testing.assert_close(out, plain, atol=CUDA_ATOL, rtol=CUDA_ATOL)
  assert torch.all(out[h:2 * h] == 0)
  dense = [p[:, layer][tables.long()].permute(0, 2, 1, 3, 4).reshape(
      b * h, cap, d).contiguous() for p in (kpool, vpool)]
  out2 = t_pfd.flash_decode(q, dense[0], dense[1], ln.repeat_interleave(h),
                            d ** -0.5)
  torch.testing.assert_close(out, out2, atol=CUDA_ATOL, rtol=CUDA_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [gm[:10] for gm in PAGED_GEOMETRIES[::2]])
@pytest.mark.parametrize("bits", [4, 5, 8])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_cuda_packed_paged_flash_decode_matches_plain_and_k4(
    cuda_device, geometry, bits, q_dtype):
  b, h, g, d, _, _, blk, nb, n_layers, layer = geometry
  dev = cuda_device
  gen = torch.Generator(device=dev).manual_seed(9)
  pool_blocks = 4 * nb
  cap = nb * blk
  lengths = ([cap, 0, 1, cap - blk + 5] * b)[:b]
  tables, ln = _paged_inputs(gen, dev, b, nb, blk, pool_blocks, lengths)
  q = torch.randn(b * h, g, d, generator=gen, device=dev).to(q_dtype)
  group = t_pk.group_size(d)
  pools = []
  for _ in range(2):
    x = torch.randn(pool_blocks + 1, n_layers, h, blk, d, generator=gen,
                    device=dev)
    pools += list(t_pk.pack_rows(x, bits=bits, group=group))
  before = t_pfd.packed_paged_flash_decode.launches
  out = t_pfd.packed_paged_flash_decode(q, *pools, tables, layer, ln,
                                        d ** -0.5, bits)
  plain = t_pfd.packed_paged_flash_decode_plain(q, *pools, tables, layer, ln,
                                                d ** -0.5, bits)
  torch.cuda.synchronize()
  assert t_pfd.packed_paged_flash_decode.launches == before + 1
  torch.testing.assert_close(out, plain, atol=CUDA_ATOL, rtol=CUDA_ATOL)
  assert torch.all(out[h:2 * h] == 0)
  assert torch.equal(out, t_pfd.packed_paged_flash_decode(
      q, *pools, tables, layer, ln, d ** -0.5, bits)), "two K5 calls differ"
  # K4 on the f32 pools of the plain dequant: the same function, its sums in
  # one pass where K5 splits the pages
  kf = t_pk.dequant_page(*pools[:3], bits=bits, group=group)
  vf = t_pk.dequant_page(*pools[3:], bits=bits, group=group)
  out4 = t_pfd.paged_flash_decode(q.float(), kf, vf, tables, layer, ln,
                                  d ** -0.5)
  torch.testing.assert_close(out, out4, atol=CUDA_ATOL, rtol=CUDA_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [gm[:10] for gm in PAGED_GEOMETRIES[::2]])
@pytest.mark.parametrize("bits", [4, 5, 8])
def test_cuda_packed_paged_flash_decode_steps_and_two_calls(
    cuda_device, geometry, bits):
  b, h, g, d, _, _, blk, nb, n_layers, layer = geometry
  dev = cuda_device
  gen = torch.Generator(device=dev).manual_seed(14)
  pool_blocks = 4 * nb
  cap = nb * blk
  n_split, chunk = t_pfd.flash_decode_split(
      b * h, cap, torch.cuda.get_device_properties(dev).multi_processor_count)
  assert n_split > 1 or cap <= t_pfd.DECODE_TILE
  q = torch.randn(b * h, g, d, generator=gen, device=dev).to(torch.bfloat16)
  group = t_pk.group_size(d)
  pools = []
  for _ in range(2):
    x = torch.randn(pool_blocks + 1, n_layers, h, blk, d, generator=gen,
                    device=dev)
    pools += list(t_pk.pack_rows(x, bits=bits, group=group))
  # rows on a chunk boundary and one token either side of it, empty, full
  special = [min(x, cap) for x in (chunk - 1, chunk, chunk + 1, 0, 1, cap,
                                   2 * chunk - 1, 2 * chunk + 1)]
  for i in range(0, len(special), b):
    lengths = (special[i:i + b] * b)[:b]
    tables, ln = _paged_inputs(gen, dev, b, nb, blk, pool_blocks, lengths)
    args = (q, *pools, tables, layer, ln, d ** -0.5, bits)
    out = t_pfd.packed_paged_flash_decode(*args)
    again = t_pfd.packed_paged_flash_decode(*args)
    plain = t_pfd.packed_paged_flash_decode_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again), "two K5 calls differ"
    torch.testing.assert_close(out, plain, atol=CUDA_ATOL, rtol=CUDA_ATOL)
    # each step against its plain version: the split kernel's partials, and
    # K2's merge kernel on those partials against the plain merge
    acc, st = t_pfd.packed_paged_flash_decode_partials(*args, n_split, chunk)
    p_acc, p_st = t_pfd.packed_paged_flash_decode_partials_plain(
        *args, n_split, chunk)
    torch.testing.assert_close(acc, p_acc, atol=CUDA_ATOL, rtol=CUDA_ATOL)
    torch.testing.assert_close(st, p_st, atol=CUDA_ATOL, rtol=CUDA_ATOL)
    merged = t_pfd.flash_decode_merge(acc, st)
    torch.testing.assert_close(merged, t_pfd.flash_decode_merge_plain(acc, st),
                               atol=CUDA_ATOL, rtol=CUDA_ATOL)
    assert torch.equal(merged, out)


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,k,dsub", [
    (512, 1024, 512, 2),     # the serve path's prefill: B*H*m, body, K
    (128, 1024, 512, 2),     # an engine admission (batch 1)
    (8, 300, 16, 4),         # reduced tinyllama, a ragged N
    (3, 100, 64, 16),
])
@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.float32),
                                    (torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16)])
def test_cuda_kmeans_assign_matches_plain(cuda_device, r, n, k, dsub, dtypes):
  dev = cuda_device
  gen = torch.Generator(device=dev).manual_seed(10)
  x = torch.randn(r, n, dsub, generator=gen, device=dev).to(dtypes[0])
  c = torch.randn(r, k, dsub, generator=gen, device=dev).to(dtypes[1])
  before = t_k6.kmeans_assign.launches
  got = t_k6.kmeans_assign(x, c)
  want = t_k6.kmeans_assign_plain(x, c)
  torch.cuda.synchronize()
  assert t_k6.kmeans_assign.launches == before + 1
  assert got.dtype == torch.int32 and got.shape == (r, n)
  assert torch.equal(got, want)


def _planted(gen, dev, r, n, k, dsub, x_dtype):
  """K6 inputs with exact ties (each centroid twice, points on centroids),
  NaN and +-inf in points and centroids, and finite values large enough
  that products overflow (rows 1-5 of R; every row has the ties)."""
  half = torch.randn(r, (k + 1) // 2, dsub, generator=gen, device=dev)
  c = torch.cat([half, half.flip(1)], dim=1)[:, :k].contiguous()
  x = torch.randn(r, n, dsub, generator=gen, device=dev)
  on = torch.randint(0, k, (r, n // 4), generator=gen, device=dev)
  x[:, ::4][:, :on.shape[1]] = torch.gather(
      c, 1, on[..., None].expand(-1, -1, dsub))
  plant = [(x, 0, 3, float("nan")), (x, 1, 5, float("inf")),
           (x, 2, 7, -float("inf")), (c, 3, k // 2, float("nan")),
           (c, 4, 0, float("inf")), (x, 5, 9, 3e38)]
  for t, row, i, v in plant:
    if row < r and i < t.shape[1]:
      t[row, i, 0] = v
  if r > 5:
    c[5, 1, :] = 1e30          # finite, but x . c overflows to inf
  return x.to(x_dtype), c


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,k,dsub", [
    (512, 1024, 512, 2),     # the serve prefill, no split of the centroids
    (128, 1024, 512, 2),     # an engine admission, 4 lanes per point
    (1, 1024, 512, 2),
    (6, 50, 3, 4),           # 2 lanes: as many as the centroids allow
    (6, 300, 16, 16),
])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_cuda_kmeans_assign_planted_ties_nan_inf(cuda_device, r, n, k, dsub,
                                                 x_dtype):
  dev = cuda_device
  gen = torch.Generator(device=dev).manual_seed(14)
  x, c = _planted(gen, dev, r, n, k, dsub, x_dtype)
  before = t_k6.kmeans_assign.launches
  got = t_k6.kmeans_assign(x, c)
  want = t_k6.kmeans_assign_plain(x, c)
  torch.cuda.synchronize()
  assert t_k6.kmeans_assign.launches == before + 1
  bad = got != want
  assert not bad.any(), (
      f"{int(bad.sum())} ids differ, first at {bad.nonzero()[:4].tolist()}")


def _b0_inputs(gen, dev, r, n, k, dsub, x_dtype, kind):
  """B0 inputs on the card: x (R, N, dsub) in x_dtype, w (R, N) f32, ids
  (R, N) int32 and old centroids (R, K, dsub) f32.  kind: 'k6' (the ids K6
  gives x against random centroids, as in the prefill); 'empty' (even ids
  only); 'zero_w' (every 4th weight 0 and cluster 1 weightless); 'one'
  (every point in cluster 3)."""
  x = torch.randn(r, n, dsub, generator=gen, device=dev).to(x_dtype)
  w = torch.rand(r, n, generator=gen, device=dev) + 0.05
  c = torch.randn(r, k, dsub, generator=gen, device=dev)
  a = torch.randint(0, k, (r, n), generator=gen, device=dev,
                    dtype=torch.int32)
  if kind == "k6":
    a = t_k6.kmeans_assign(x, c)
  elif kind == "empty":
    a = (a // 2) * 2
  elif kind == "zero_w":
    w[:, ::4] = 0
    w[a == 1] = 0
  elif kind == "one":
    a[:] = 3 % k
  return x, w, a, c


def _check_b0(got, x, w, a, c):
  """got against the plain version within the tolerance, frozen clusters
  bit-equal to the old centroids; returns the worst share of the bound."""
  want = t_b0.kmeans_update_plain(x, w, a, c)
  tol, empty = t_b0.kmeans_update_tolerance(x, w, a, c)
  assert got.dtype == torch.float32 and got.shape == c.shape
  assert torch.equal(got[empty], c[empty]), "a frozen cluster moved"
  share = float(((got - want).abs() / tol).max())
  assert share <= 1.0, f"B0 exceeds its bound ({share:.3f} of it)"
  return share


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,k,dsub", [
    (512, 1024, 512, 2),       # the serve prefill (B 4 x Hkv 4 x m 32)
    (128, 1024, 512, 2),       # an engine admission
    (6, 100, 512, 2),          # K > N
    (3, 1000, 16, 4), (2, 64, 8, 16), (1, 1, 4, 1),
    (4, 16384, 512, 2),        # a 16k body: 16 tiles of the row
    (4, 10000, 512, 4),        # dsub 4 (head_dim 128), a ragged last tile
])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["k6", "empty", "zero_w", "one"])
def test_cuda_kmeans_update_matches_plain(cuda_device, r, n, k, dsub, x_dtype,
                                          kind):
  dev = cuda_device
  gen = torch.Generator(device=dev).manual_seed(15)
  x, w, a, c = _b0_inputs(gen, dev, r, n, k, dsub, x_dtype, kind)
  before = t_b0.kmeans_update.launches
  got = t_b0.kmeans_update(x, w, a, c)
  again = t_b0.kmeans_update(x, w, a, c)
  torch.cuda.synchronize()
  assert t_b0.kmeans_update.launches == before + 2
  assert torch.equal(got, again), "two B0 calls differ"
  _check_b0(got, x, w, a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("d,m", [(64, 32), (128, 32)])
def test_cuda_long_pq_prefill_runs_b0(cuda_device, d, m):
  """A 16k-token pq prefill (the body one row of each k-means) through K6
  and B0, at dsub 2 and 4: every update launches B0, and the codebooks and
  indices are finite and in range."""
  dev = cuda_device
  gen = torch.Generator(device=dev).manual_seed(16)
  b, h, n, k = 1, 2, 16384, 512
  cfg = t_kvc.PQCacheConfig(sink=4, recent=32, body_capacity=n - 36,
                            n_windows=1, pq=t_pq.PQConfig(m=m, k=k))
  kk, vv = (torch.randn(b, h, n, d, generator=gen, device=dev).to(
      torch.bfloat16) for _ in range(2))
  w = torch.rand(b, h, n, generator=gen, device=dev)
  before = t_b0.kmeans_update.launches
  got = t_kvc.pq_cache_prefill(kk, vv, w, cfg, use_kernel=True)
  torch.cuda.synchronize()
  assert t_b0.kmeans_update.launches == before + 2 * cfg.pq.iters
  for cb in (got.key_codebooks, got.value_codebooks):
    assert tuple(cb.shape) == (b, h, 1, m, k, d // m)
    assert bool(torch.isfinite(cb.float()).all())
  for idx in (got.key_indices, got.value_indices):
    assert tuple(idx.shape) == (b, h, n - 36, m)
    assert int(idx.min()) >= 0 and int(idx.max()) < k


@pytest.mark.cuda
@pytest.mark.parametrize("n,dp", [(4 * 4 * 1056, 32), (1, 8), (1000, 4)])
def test_cuda_unpack_u4_matches_plain(cuda_device, n, dp):
  dev = cuda_device
  gen = torch.Generator(device=dev).manual_seed(11)
  p = torch.randint(0, 256, (n, dp), generator=gen, device=dev,
                    dtype=torch.int32).to(torch.uint8)
  before = t_pk.unpack_u4_kernel.launches
  got = t_pk.unpack_u4_kernel(p)
  torch.cuda.synchronize()
  assert t_pk.unpack_u4_kernel.launches == before + 1
  assert torch.equal(got, t_pk.unpack_u4(p))


# every edge of a bf16 block's position tile (16, 64 or 128 positions for
# g = 8, 2, 1) and of the 64-key tile, at the smallest and largest head dim
K7_EDGES = [(1, 2 * g, 2, n, d) for n in (1, 15, 17, 129) for g in (1, 2, 8)
            for d in (16, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,n,d", [
    (4, 32, 4, 1024, 64),     # ServeRun's prefill, tinyllama-1.1b
    (1, 32, 4, 1024, 64),     # an engine admission
    (1, 32, 4, 1000, 64),     # a ragged N
    (2, 4, 2, 48, 16),        # reduced tinyllama
    (1, 8, 1, 200, 128),      # MQA, head dim 128
    (2, 6, 6, 192, 32),       # MHA
    (1, 12, 2, 300, 64),      # g = 6: two heads per block, three blocks
] + K7_EDGES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_attention_matches_plain(cuda_device, b, hq, hkv, n, d,
                                            causal, dtype):
  dev = cuda_device
  gen = torch.Generator(device=dev).manual_seed(12)
  q = torch.randn(b, hq, n, d, generator=gen, device=dev).to(dtype)
  k, v = (torch.randn(b, hkv, n, d, generator=gen, device=dev).to(dtype)
          for _ in range(2))
  before = t_k7.flash_attention.launches
  got = t_k7.flash_attention(q, k, v, d ** -0.5, causal)
  want = t_k7.flash_attention_plain(q, k, v, d ** -0.5, causal)
  torch.cuda.synchronize()
  assert t_k7.flash_attention.launches == before + 1
  assert got.dtype == dtype and got.shape == q.shape
  assert torch.isfinite(got).all()
  diff = (got.float() - want.float()).abs()
  excess = diff - t_k7.kernel_error_bound(q, k, v, d ** -0.5, causal, want)
  assert float(excess.max()) <= 0.0, (
      f"{int((excess > 0).sum())} elements exceed the bound, worst by "
      f"{float(excess.max())}; max abs err {float(diff.max())}")


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_inputs(cuda_device):
  dev = cuda_device
  q = torch.zeros(2, 2, 16, device=dev)
  cb = torch.zeros(2, 4, 16, 4, device=dev)         # f32: the kernel reads bf16
  idx = torch.zeros(2, 8, 4, dtype=torch.int32, device=dev)
  ln = torch.zeros(2, dtype=torch.int32, device=dev)
  with pytest.raises(TypeError, match="bf16"):
    t_pqd.pq_decode_attention(q, cb, cb, idx, idx, ln, 0.25)
  with pytest.raises(TypeError, match="share"):
    t_pfd.flash_decode(q, torch.zeros(2, 8, 16, dtype=torch.bfloat16,
                                      device=dev),
                       torch.zeros(2, 8, 16, dtype=torch.bfloat16, device=dev),
                       ln, 0.25)
  pool = torch.zeros(3, 2, 2, 4, 16, device=dev)
  tables = torch.zeros(1, 2, dtype=torch.int64, device=dev)
  with pytest.raises(TypeError, match="int32"):
    t_pfd.paged_flash_decode(q, pool, pool, tables, 0, ln[:1], 0.25)
  with pytest.raises(TypeError, match="Python int"):
    t_pfd.paged_flash_decode(q, pool, pool, tables.int(),
                             torch.tensor(0, device=dev), ln[:1], 0.25)
  x = torch.zeros(2, 8, 3, device=dev)
  with pytest.raises(ValueError, match="dsub"):
    t_k6.kmeans_assign(x, torch.zeros(2, 4, 3, device=dev))
  with pytest.raises(ValueError, match="contiguous"):
    t_pk.unpack_u4_kernel(torch.zeros(4, 8, dtype=torch.uint8,
                                      device=dev)[:, ::2])
  codes = torch.zeros(3, 2, 2, 4, 8, dtype=torch.uint8, device=dev)
  hdr = torch.zeros(3, 2, 2, 4, 1, dtype=torch.float16, device=dev)
  with pytest.raises(ValueError, match="code rows"):
    t_pfd.packed_paged_flash_decode(q, codes, hdr, hdr, codes, hdr, hdr,
                                    tables.int(), 0, ln[:1], 0.25, 5)
  qa = torch.zeros(1, 4, 8, 16, device=dev)
  kv = torch.zeros(1, 2, 8, 16, device=dev)
  with pytest.raises(TypeError, match="share"):
    t_k7.flash_attention(qa, kv.bfloat16(), kv.bfloat16(), 0.25)
  with pytest.raises(ValueError, match="head dim"):
    t_k7.flash_attention(qa[..., :8].contiguous(), kv[..., :8].contiguous(),
                         kv[..., :8].contiguous(), 0.25)
  with pytest.raises(ValueError, match="contiguous"):
    t_k7.flash_attention(qa.transpose(2, 3).contiguous().transpose(2, 3), kv,
                         kv, 0.25)


@pytest.mark.cuda
def test_cuda_b0_and_k5_refuse_bad_inputs(cuda_device):
  dev = cuda_device
  x = torch.zeros(2, 8, 2, device=dev)
  w = torch.zeros(2, 8, device=dev)
  a = torch.zeros(2, 8, dtype=torch.int32, device=dev)
  c = torch.zeros(2, 4, 2, device=dev)
  with pytest.raises(TypeError, match="int32"):
    t_b0.kmeans_update(x, w, a.long(), c)
  with pytest.raises(TypeError, match="bf16 or f32"):
    t_b0.kmeans_update(x.half(), w, a, c)
  with pytest.raises(ValueError, match="dsub"):
    t_b0.kmeans_update(torch.zeros(2, 8, 3, device=dev), w, a,
                       torch.zeros(2, 4, 3, device=dev))
  with pytest.raises(ValueError, match="contiguous"):
    t_b0.kmeans_update(x, torch.zeros(8, 2, device=dev).t(), a, c)
  # shared memory grows with K, not with N (the row streams in tiles)
  with pytest.raises(ValueError, match="shared memory"):
    t_b0.kmeans_update(x, w, a, torch.zeros(2, 8192, 2, device=dev))
  # K5's kernel takes d % 16 == 0
  q = torch.zeros(2, 2, 8, device=dev)
  codes = torch.zeros(3, 2, 2, 4, 4, dtype=torch.uint8, device=dev)
  hdr = torch.zeros(3, 2, 2, 4, 1, dtype=torch.float16, device=dev)
  tables = torch.zeros(1, 2, dtype=torch.int32, device=dev)
  ln = torch.zeros(1, dtype=torch.int32, device=dev)
  with pytest.raises(ValueError, match="d % 16"):
    t_pfd.packed_paged_flash_decode(q, codes, hdr, hdr, codes, hdr, hdr,
                                    tables, 0, ln, 0.25, 4)
