"""The decode kernels' plain versions against the reference, and the CUDA
kernels against their plain versions.

CPU legs (always run): the plain K1 against `repro.kernels.ref.
pq_decode_attention_ref` and `pq_decode_attention_kernel(interpret=True)`;
the plain K2 against `flash_decode_kernel(interpret=True)`; the batched
wrappers and `combine_attention_segments` against `repro.kernels.ops`.
Tolerance 1e-5: f32 on the CPU, same inputs, sums in another order.
K2's split-K on the CPU: `flash_decode_split` cuts every capacity into
whole 64-token chunks within the grid's limits, and the plain partials
merged by the plain merge match `flash_decode_plain` and the interpret-mode
kernel within 1e-6 (f32, short rows), length-0 rows giving 0.

The CUDA legs (kernel against plain version on the card) are in
`test_torch_cuda_kernels.py`, which imports no JAX so it runs on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import paged_flash_decode as j_pfd
from repro.kernels import pq_decode as j_pqd
from repro.kernels import ref as j_ref
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import paged_flash_decode as t_pfd
from repro_torch.kernels import pq_decode as t_pqd

ATOL = RTOL = 1e-5


def _bf16_values(rng, shape):
  """f32 values that bf16 holds exactly (the codebooks' storage type)."""
  x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
  return x.to(torch.bfloat16).float().numpy()


def _pq_inputs(rng, bh, g, d, m, k, n, lengths, idx_dtype):
  return dict(
      q=rng.normal(size=(bh, g, d)).astype(np.float32),
      kcb=_bf16_values(rng, (bh, m, k, d // m)),
      vcb=_bf16_values(rng, (bh, m, k, d // m)),
      kidx=rng.integers(0, k, size=(bh, n, m)).astype(idx_dtype),
      vidx=rng.integers(0, k, size=(bh, n, m)).astype(idx_dtype),
      length=np.asarray(lengths, np.int32))


def _port_pq(inp, scale):
  return t_pqd.pq_decode_attention(
      torch.tensor(inp["q"]), torch.tensor(inp["kcb"]).to(torch.bfloat16),
      torch.tensor(inp["vcb"]).to(torch.bfloat16), torch.tensor(inp["kidx"]),
      torch.tensor(inp["vidx"]), torch.tensor(inp["length"]), scale)


@pytest.mark.parametrize("idx_dtype,k", [(np.uint8, 16), (np.int16, 512)])
@pytest.mark.parametrize("lengths", [[0, 64, 17, 1], [33, 0, 64, 48]])
def test_plain_pq_decode_matches_reference_and_interpret_kernel(
    idx_dtype, k, lengths):
  rng = np.random.default_rng(0)
  bh, g, d, m, n = 4, 2, 16, 4, 64
  inp = _pq_inputs(rng, bh, g, d, m, k, n, lengths, idx_dtype)
  scale = d ** -0.5
  out, stats = _port_pq(inp, scale)
  assert out.dtype == torch.float32 and tuple(stats.shape) == (bh, 2, g)

  kix = jnp.asarray(inp["kidx"].astype(np.int32))
  vix = jnp.asarray(inp["vidx"].astype(np.int32))
  r_out, r_stats = j_ref.pq_decode_attention_ref(
      jnp.asarray(inp["q"]), jnp.asarray(inp["kcb"]), jnp.asarray(inp["vcb"]),
      kix, vix, jnp.asarray(inp["length"]), scale)
  np.testing.assert_allclose(out.numpy(), np.asarray(r_out), atol=ATOL,
                             rtol=RTOL)
  np.testing.assert_allclose(stats.numpy(), np.asarray(r_stats), atol=ATOL,
                             rtol=RTOL)

  k_out, k_stats = j_pqd.pq_decode_attention_kernel(
      jnp.asarray(inp["q"]), jnp.asarray(inp["kcb"]),
      jnp.swapaxes(jnp.asarray(inp["vcb"]), -1, -2), kix, vix,
      jnp.asarray(inp["length"]), scale=scale, blk=16, interpret=True)
  np.testing.assert_allclose(out.numpy(), np.asarray(k_out), atol=ATOL,
                             rtol=RTOL)
  np.testing.assert_allclose(stats.numpy(), np.asarray(k_stats), atol=ATOL,
                             rtol=RTOL)
  empty = inp["length"] == 0
  assert np.all(out.numpy()[empty] == 0) and np.all(
      stats.numpy()[empty, 1] == 0)


@pytest.mark.parametrize("lengths", [[0, 64, 17, 1], [48, 5, 0, 64]])
def test_plain_flash_decode_matches_interpret_kernel(lengths):
  rng = np.random.default_rng(1)
  bh, g, d, n = 4, 3, 16, 64
  q = rng.normal(size=(bh, g, d)).astype(np.float32)
  k = rng.normal(size=(bh, n, d)).astype(np.float32)
  v = rng.normal(size=(bh, n, d)).astype(np.float32)
  ln = np.asarray(lengths, np.int32)
  out = t_pfd.flash_decode(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                           torch.tensor(ln), 0.25)
  ref = j_pfd.flash_decode_kernel(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(ln), scale=0.25,
                                  blk=16, interpret=True)
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                             rtol=RTOL)


SPLIT_NS = sorted(set(range(1, 300)) | set(range(300, 32769, 97))
                  | {511, 512, 513, 1023, 1024, 1025, 1040, 16384, 32767,
                     32768})


@pytest.mark.parametrize("bh", [1, 2, 3, 7, 16, 17, 64, 100, 132, 133, 256])
def test_flash_decode_split_cuts_every_capacity(bh):
  for n in SPLIT_NS:
    s, chunk = t_pfd.flash_decode_split(bh, n)
    tiles = -(-n // t_pfd.DECODE_TILE)
    assert 1 <= s <= min(tiles, -(-2 * t_pfd.H100_SMS // bh)), (bh, n, s)
    assert chunk % t_pfd.DECODE_TILE == 0 and chunk > 0, (bh, n, chunk)
    # chunks [i chunk, min((i + 1) chunk, n)) cover [0, n) once: all whole
    # tiles but the last, which starts below n
    assert (s - 1) * chunk < n <= s * chunk, (bh, n, s, chunk)
    assert s <= 65535 and bh * s <= 2 ** 31 - 1
  # the wrapper's default is the H100's SM count; another count moves S
  assert t_pfd.flash_decode_split(16, 1040) == (17, 64)
  assert t_pfd.flash_decode_split(16, 1040, sms=66) == (9, 128)


@pytest.mark.parametrize("n,split", [(64, (1, 64)), (128, (2, 64)),
                                     (192, (3, 64)), (192, (2, 128)),
                                     (192, None)])
@pytest.mark.parametrize("lengths", [[0, 64, 17, 1], [48, 5, 0, 192],
                                     [65, 63, 128, 129]])
def test_plain_split_merge_matches_plain_and_interpret_kernel(n, split,
                                                              lengths):
  rng = np.random.default_rng(5)
  bh, g, d = 4, 3, 16
  q = rng.normal(size=(bh, g, d)).astype(np.float32)
  k = rng.normal(size=(bh, n, d)).astype(np.float32)
  v = rng.normal(size=(bh, n, d)).astype(np.float32)
  ln = np.minimum(np.asarray(lengths, np.int32), n)
  n_split, chunk = split or t_pfd.flash_decode_split(bh, n)
  args = (torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(ln),
          0.25)
  acc, stats = t_pfd.flash_decode_partials_plain(*args, n_split, chunk)
  assert acc.shape == (bh, n_split, g, d) and stats.shape == (bh, n_split,
                                                               2, g)
  out = t_pfd.flash_decode_merge_plain(acc, stats)
  np.testing.assert_allclose(out.numpy(),
                             t_pfd.flash_decode_plain(*args).numpy(),
                             atol=1e-6, rtol=1e-6)
  ref = j_pfd.flash_decode_kernel(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(ln), scale=0.25,
                                  blk=16, interpret=True)
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                             rtol=1e-6)
  assert np.all(out.numpy()[ln == 0] == 0)
  # a chunk with no token below the length is the empty partial
  empty = torch.arange(n_split)[None, :] * chunk >= torch.tensor(ln)[:, None]
  assert torch.all(stats[:, :, 0][empty] == float("-inf"))
  assert torch.all(stats[:, :, 1][empty] == 0) and torch.all(acc[empty] == 0)
  # the step wrappers take the plain versions on CPU tensors, uncounted
  before = t_pfd.flash_decode.launches
  acc2, stats2 = t_pfd.flash_decode_partials(*args, n_split, chunk)
  assert torch.equal(acc2, acc) and torch.equal(stats2, stats)
  assert torch.equal(t_pfd.flash_decode_merge(acc, stats), out)
  assert t_pfd.flash_decode.launches == before


def test_batched_wrappers_match_reference_ops():
  rng = np.random.default_rng(2)
  b, h, g, d, m, k, n = 2, 2, 2, 16, 4, 16, 32
  q = rng.normal(size=(b, h, g, d)).astype(np.float32)
  kcb = _bf16_values(rng, (b, h, m, k, d // m))
  vcb = _bf16_values(rng, (b, h, m, k, d // m))
  kidx = rng.integers(0, k, size=(b, h, n, m)).astype(np.int32)
  vidx = rng.integers(0, k, size=(b, h, n, m)).astype(np.int32)
  ln = np.asarray([[20, 20], [0, 0]], np.int32)
  j = j_ops.pq_decode_attention(
      jnp.asarray(q), jnp.asarray(kcb), jnp.asarray(vcb), jnp.asarray(kidx),
      jnp.asarray(vidx), jnp.asarray(ln), 0.25, blk=16, interpret=True)
  t = t_ops.pq_decode_attention(
      torch.tensor(q), torch.tensor(kcb).to(torch.bfloat16),
      torch.tensor(vcb).to(torch.bfloat16), torch.tensor(kidx),
      torch.tensor(vidx), torch.tensor(ln), 0.25)
  for a, r in zip(t, j):
    np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL)

  kk = rng.normal(size=(b, h, n, d)).astype(np.float32)
  vv = rng.normal(size=(b, h, n, d)).astype(np.float32)
  lens = np.asarray([9, 32], np.int32)
  j = j_ops.flash_decode(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv),
                         jnp.asarray(lens), 0.25, interpret=True)
  t = t_ops.flash_decode(torch.tensor(q), torch.tensor(kk), torch.tensor(vv),
                         torch.tensor(lens), 0.25)
  np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)


def test_combine_attention_segments_matches_reference():
  rng = np.random.default_rng(3)
  shape = (2, 3, 4)
  outs = [rng.normal(size=shape + (8,)).astype(np.float32) for _ in range(3)]
  maxes = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
  maxes[1][0] = -1e30                                   # an empty segment
  denoms = [rng.uniform(0.5, 3, size=shape).astype(np.float32)
            for _ in range(3)]
  denoms[1][0] = 0.0
  j = j_ops.combine_attention_segments(
      [jnp.asarray(o) for o in outs], [jnp.asarray(x) for x in maxes],
      [jnp.asarray(x) for x in denoms])
  t = t_ops.combine_attention_segments(
      [torch.tensor(o) for o in outs], [torch.tensor(x) for x in maxes],
      [torch.tensor(x) for x in denoms])
  np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=RTOL)


def test_cpu_tensors_take_the_plain_version_without_launching():
  rng = np.random.default_rng(4)
  inp = _pq_inputs(rng, 2, 2, 16, 4, 16, 32, [5, 32], np.uint8)
  before = t_pqd.pq_decode_attention.launches
  out, stats = _port_pq(inp, 0.25)
  plain = t_pqd.pq_decode_attention_plain(
      torch.tensor(inp["q"]), torch.tensor(inp["kcb"]).to(torch.bfloat16),
      torch.tensor(inp["vcb"]).to(torch.bfloat16), torch.tensor(inp["kidx"]),
      torch.tensor(inp["vidx"]), torch.tensor(inp["length"]), 0.25)
  assert torch.equal(out, plain[0]) and torch.equal(stats, plain[1])
  assert t_pqd.pq_decode_attention.launches == before
  with pytest.raises(ValueError):
    t_pqd.pq_decode_attention(torch.zeros(2, 2, 16), torch.zeros(2, 4, 16, 4),
                              torch.zeros(2, 4, 16, 4),
                              torch.zeros(2, 8, 3, dtype=torch.int32),
                              torch.zeros(2, 8, 4, dtype=torch.int32),
                              torch.zeros(2, dtype=torch.int32), 0.25)
