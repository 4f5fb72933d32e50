"""K6, the k-means assignment step, against the reference on the CPU.

  - `kmeans_assign_plain` (and the wrapper, which takes it for CPU tensors)
    equal to `repro.kernels.ops.kmeans_assign` in interpret mode, at the
    shapes of the reference's own kernel test, on tie-free inputs (normal
    draws from a numpy seed), in f32 and bf16;
  - on the same inputs, equal to the port's plain `assign_clusters` (the
    full distance) and so to the reference's;
  - with planted exact ties (every centroid twice, points on centroids),
    `kmeans_assign_plain` and the interpret kernel both take the first
    index;
  - `kmeans_assign_geometry` picks the least split of the centroids over
    lanes that gives 3 blocks per SM (512 blocks at R = 512 and R = 128),
    never more lanes than centroids;
  - the PQ prefill's wiring: with `use_kernel` every k-means assignment of
    a codebook build goes through K6's batched wrapper (iters + 1 per
    window, for K and V), and the codebooks and indices equal the plain
    build's on these inputs.

The CUDA leg (the kernel against its plain version on the card) is in
`test_torch_cuda_kernels.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro_torch.core import kmeans as t_kmeans
from repro_torch.core import kv_cache as t_kvc
from repro_torch.core import pq as t_pq
from repro_torch.kernels import kmeans_assign as t_k6
from repro_torch.kernels import ops as t_ops


def _inputs(m, n, dsub, k):
  # the reference's kernel test draws its inputs this way
  rng = np.random.default_rng(hash((m, n, dsub, k)) % 2**31)
  x = rng.normal(size=(m, n, dsub)).astype(np.float32)
  c = rng.normal(size=(m, k, dsub)).astype(np.float32)
  return x, c


@pytest.mark.parametrize("m,n,dsub,k", [
    (1, 64, 4, 8), (4, 300, 8, 32), (8, 1024, 16, 64), (2, 100, 2, 512),
])
def test_kmeans_assign_matches_interpret_kernel(m, n, dsub, k):
  x, c = _inputs(m, n, dsub, k)
  want = np.asarray(j_ops.kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                                        blk=128, interpret=True))
  before = t_k6.kmeans_assign.launches
  got = t_k6.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
  assert t_k6.kmeans_assign.launches == before    # CPU: the plain version
  assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
  np.testing.assert_array_equal(got.numpy(), want)
  np.testing.assert_array_equal(
      t_k6.kmeans_assign_plain(torch.from_numpy(x),
                               torch.from_numpy(c)).numpy(), want)
  # tie-free: the full distance picks the same ids
  np.testing.assert_array_equal(
      t_kmeans.assign_clusters(torch.from_numpy(x),
                               torch.from_numpy(c)).numpy(), want)


def test_kmeans_assign_bf16_matches_interpret_kernel():
  rng = np.random.default_rng(0)
  x = torch.from_numpy(rng.normal(size=(2, 256, 8)).astype(np.float32))
  c = torch.from_numpy(rng.normal(size=(2, 16, 8)).astype(np.float32))
  x, c = x.to(torch.bfloat16), c.to(torch.bfloat16)
  want = j_ops.kmeans_assign(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                             jnp.asarray(c.float().numpy(), jnp.bfloat16),
                             blk=128, interpret=True)
  got = t_k6.kmeans_assign(x, c)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_wrapper_folds_leading_dims():
  rng = np.random.default_rng(3)
  x = torch.from_numpy(rng.normal(size=(2, 3, 4, 40, 2)).astype(np.float32))
  c = torch.from_numpy(rng.normal(size=(2, 3, 4, 16, 2)).astype(np.float32))
  x_strided = x.transpose(-2, -3).contiguous().transpose(-2, -3)
  assert not x_strided.is_contiguous()
  got = t_ops.kmeans_assign(x_strided, c)
  assert tuple(got.shape) == (2, 3, 4, 40)
  np.testing.assert_array_equal(
      got.numpy(), t_kmeans.assign_clusters(x, c).numpy())


@pytest.mark.parametrize("n_windows", [1, 2])
def test_pq_prefill_runs_every_assignment_through_k6(monkeypatch, n_windows):
  rng = np.random.default_rng(4)
  b, h, n, d, m, k = 1, 2, 40, 16, 4, 16
  cfg = t_kvc.PQCacheConfig(sink=4, recent=8, body_capacity=32,
                            n_windows=n_windows, pq=t_pq.PQConfig(m=m, k=k))
  kk, vv = (torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32))
            for _ in range(2))
  w = torch.from_numpy(rng.random((b, h, n)).astype(np.float32))
  calls = []
  batched = t_ops.kmeans_assign

  def counted(x, centroids):
    calls.append(tuple(x.shape))
    return batched(x, centroids)
  monkeypatch.setattr(t_ops, "kmeans_assign", counted)
  got = t_kvc.pq_cache_prefill(kk, vv, w, cfg, use_kernel=True)
  # iters + 1 assignments per window, for the key and the value codebooks
  assert len(calls) == (cfg.pq.iters + 1) * n_windows * 2
  assert all(s == (b, h, m, cfg.window_len, d // m) for s in calls)
  calls.clear()
  want = t_kvc.pq_cache_prefill(kk, vv, w, cfg)
  assert not calls
  for f in got._fields:
    torch.testing.assert_close(getattr(got, f), getattr(want, f),
                               atol=0, rtol=0)


@pytest.mark.parametrize("dsub,k", [(2, 512), (4, 16), (16, 64)])
def test_planted_ties_take_the_first_index(dsub, k):
  # every centroid appears twice (a second copy later in the row) and some
  # points sit on a centroid: the distances tie exactly, and
  # `kmeans_assign_plain` and the reference's interpret kernel both take the
  # first copy
  rng = np.random.default_rng(7)
  m, n = 3, 128
  half = rng.normal(size=(m, k // 2, dsub)).astype(np.float32)
  c = np.concatenate([half, half[:, ::-1]], axis=1)
  x = rng.normal(size=(m, n, dsub)).astype(np.float32)
  x[:, ::4] = c[:, rng.integers(0, k, size=n // 4)]
  want = np.asarray(j_ops.kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                                        blk=128, interpret=True))
  got = t_k6.kmeans_assign_plain(torch.from_numpy(x), torch.from_numpy(c))
  np.testing.assert_array_equal(got.numpy(), want)
  # the first of the two copies: an id below k // 2 is the original row,
  # above it the mirrored copy (k - 1 - i) of original i
  first = np.minimum(want, k - 1 - want)
  assert np.all(want == first)


@pytest.mark.parametrize("r,n,k", [(512, 1024, 512), (128, 1024, 512),
                                   (8, 300, 16), (1, 64, 8), (4, 10, 1),
                                   (1, 1, 2), (3, 100, 3), (2048, 1024, 512)])
def test_kmeans_assign_geometry_fills_the_card(r, n, k):
  sms = 132
  lanes = t_k6.kmeans_assign_geometry(r, n, k, sms)
  assert lanes in t_k6.LANES and lanes <= k
  blocks = r * -(-n // (t_k6.THREADS // lanes * t_k6.POINTS))
  # the least split with 3 blocks per SM, or the widest the centroids allow
  narrower = [l for l in t_k6.LANES if l < lanes]
  assert all(r * -(-n // (t_k6.THREADS // l * t_k6.POINTS)) < 3 * sms
             for l in narrower)
  assert blocks >= 3 * sms or lanes == t_k6.LANES[-1] or 2 * lanes > k
  # the serve prefill and an engine admission both launch 512 blocks
  if (n, k) == (1024, 512) and r in (128, 512):
    assert blocks == 512
