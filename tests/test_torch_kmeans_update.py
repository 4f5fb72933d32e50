"""B0, the k-means centroid update, against the reference on the CPU.

  - `kmeans_update_plain` (and the wrapper, which takes it for CPU tensors)
    against `repro.core.kmeans._weighted_update` vmapped over R, with empty
    clusters, zero weights (masked rows), every point in one cluster and
    K > N; empty clusters equal the old centroid bit for bit, the rest
    within 1e-6 (f32 on the CPU, the same one-hot matmul summed in another
    order);
  - the batched wrapper `kernels.ops.kmeans_update` folds the leading dims
    (strided x, broadcast weights) and gives the plain version's bits;
  - `weighted_kmeans(use_kernel=True)` sends every update through
    `kernels.ops.kmeans_update` and still matches the reference, and the PQ
    prefill with `use_kernel` sends every update of every window there
    (iters per window, for K and V) with codebooks and indices equal to the
    plain build's;
  - `kmeans_update_tolerance` marks exactly the empty clusters, and its
    bound is REL_TOL of the cluster's mean |w x| plus ABS_TOL;
  - the wrapper refuses shapes it does not take.

The CUDA leg (the kernel against its plain version on the card, two calls
bit-equal) is in `test_torch_cuda_kernels.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as j_km
from repro_torch.core import kmeans as t_km
from repro_torch.core import kv_cache as t_kvc
from repro_torch.core import pq as t_pq
from repro_torch.kernels import kmeans_update as t_b0
from repro_torch.kernels import ops as t_ops

ATOL = RTOL = 1e-6


def _case(seed, r, n, k, dsub, kind):
  """x (R, N, dsub), w (R, N), assign (R, N) int32, centroids (R, K, dsub)
  f32 from a numpy seed.  kind: 'random' ids; 'empty' (only even ids, so
  every odd cluster is empty); 'zero_w' (a quarter of the weights 0, and
  cluster 1's members all weightless); 'one' (every point in cluster 3)."""
  rng = np.random.default_rng(seed)
  x = rng.normal(size=(r, n, dsub)).astype(np.float32)
  w = rng.uniform(0.1, 2.0, size=(r, n)).astype(np.float32)
  c = rng.normal(size=(r, k, dsub)).astype(np.float32)
  a = rng.integers(0, k, size=(r, n)).astype(np.int32)
  if kind == "empty":
    a = (a // 2) * 2
  elif kind == "zero_w":
    w[:, ::4] = 0.0
    w[a == 1] = 0.0
  elif kind == "one":
    a[:] = 3 % k
  return x, w, a, c


def _reference(x, w, a, c):
  return np.asarray(jax.vmap(j_km._weighted_update)(
      jnp.asarray(x), jnp.asarray(w), jnp.asarray(a), jnp.asarray(c)))


@pytest.mark.parametrize("r,n,k,dsub", [(4, 64, 16, 2), (3, 100, 8, 4),
                                         (2, 10, 32, 2), (2, 128, 64, 1)])
@pytest.mark.parametrize("kind", ["random", "empty", "zero_w", "one"])
def test_plain_update_matches_reference(r, n, k, dsub, kind):
  x, w, a, c = _case(7, r, n, k, dsub, kind)
  want = _reference(x, w, a, c)
  args = [torch.from_numpy(v) for v in (x, w, a, c)]
  before = t_b0.kmeans_update.launches
  got = t_b0.kmeans_update(*args)
  assert t_b0.kmeans_update.launches == before    # CPU: the plain version
  assert got.dtype == torch.float32 and tuple(got.shape) == (r, k, dsub)
  np.testing.assert_array_equal(got.numpy(),
                                t_b0.kmeans_update_plain(*args).numpy())
  counts = np.stack([np.bincount(row, minlength=k) for row in a])
  mass = np.stack([np.bincount(row, weights=wr, minlength=k)
                   for row, wr in zip(a, w)])
  empty = mass <= t_b0.EMPTY
  assert empty.any() or kind == "random"
  # frozen clusters keep the old centroid, bit for bit
  np.testing.assert_array_equal(got.numpy()[empty], c[empty])
  np.testing.assert_array_equal(want[empty], c[empty])
  np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
  if kind == "one":
    assert (counts[:, 3 % k] == n).all()


def test_update_bf16_points_matches_reference():
  x, w, a, c = _case(8, 4, 200, 16, 2, "random")
  xb = torch.from_numpy(x).to(torch.bfloat16)
  want = _reference(np.asarray(xb.float()), w, a, c)
  got = t_b0.kmeans_update(xb, torch.from_numpy(w), torch.from_numpy(a),
                           torch.from_numpy(c))
  np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_batched_wrapper_folds_leading_dims():
  rng = np.random.default_rng(3)
  x = torch.from_numpy(rng.normal(size=(2, 3, 4, 40, 2)).astype(np.float32))
  w = torch.from_numpy(rng.random((2, 3, 1, 40)).astype(np.float32))
  a = torch.from_numpy(rng.integers(0, 16, size=(2, 3, 4, 40)).astype(
      np.int32))
  c = torch.from_numpy(rng.normal(size=(2, 3, 4, 16, 2)).astype(np.float32))
  x_strided = x.transpose(-2, -3).contiguous().transpose(-2, -3)
  assert not x_strided.is_contiguous()
  w_wide = w.expand(2, 3, 4, 40)
  got = t_ops.kmeans_update(x_strided, w_wide, a, c)
  assert tuple(got.shape) == (2, 3, 4, 16, 2)
  np.testing.assert_array_equal(
      got.numpy(), t_km.weighted_update(x, w_wide, a, c).numpy())


def _clustered(rng, n, k, dsub, spread=0.05):
  centers = rng.normal(size=(k, dsub)) * 3.0
  labels = rng.integers(0, k, size=n)
  return (centers[labels] + spread * rng.normal(size=(n, dsub))).astype(
      np.float32)


@pytest.mark.parametrize("seed,masked", [(0, False), (1, True)])
def test_weighted_kmeans_runs_every_update_through_b0(monkeypatch, seed,
                                                      masked):
  rng = np.random.default_rng(seed)
  n, k, dsub = 96, 16, 4
  x = _clustered(rng, n, k, dsub)
  w = rng.uniform(0.1, 2.0, size=n).astype(np.float32)
  mask = np.arange(n) < 70 if masked else None
  calls = []
  batched = t_ops.kmeans_update

  def counted(*args):
    calls.append(tuple(args[0].shape))
    return batched(*args)
  monkeypatch.setattr(t_ops, "kmeans_update", counted)
  tm = None if mask is None else torch.from_numpy(mask)
  tc, ta = t_km.weighted_kmeans(torch.from_numpy(x), torch.from_numpy(w), k,
                                mask=tm, use_kernel=True)
  assert calls == [(n, dsub)] * t_km.DEFAULT_ITERS
  calls.clear()
  pc, pa = t_km.weighted_kmeans(torch.from_numpy(x), torch.from_numpy(w), k,
                                mask=tm)
  assert not calls
  np.testing.assert_array_equal(tc.numpy(), pc.numpy())
  np.testing.assert_array_equal(ta.numpy(), pa.numpy())
  jc, ja = j_km.weighted_kmeans(
      jnp.asarray(x), jnp.asarray(w), k=k,
      mask=None if mask is None else jnp.asarray(mask))
  np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
  np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5,
                             rtol=1e-5)


@pytest.mark.parametrize("n_windows", [1, 2])
def test_pq_prefill_runs_every_update_through_b0(monkeypatch, n_windows):
  rng = np.random.default_rng(4)
  b, h, n, d, m, k = 1, 2, 40, 16, 4, 16
  cfg = t_kvc.PQCacheConfig(sink=4, recent=8, body_capacity=32,
                            n_windows=n_windows, pq=t_pq.PQConfig(m=m, k=k))
  kk, vv = (torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32))
            for _ in range(2))
  w = torch.from_numpy(rng.random((b, h, n)).astype(np.float32))
  calls = []
  batched = t_ops.kmeans_update

  def counted(x, *rest):
    calls.append(tuple(x.shape))
    return batched(x, *rest)
  monkeypatch.setattr(t_ops, "kmeans_update", counted)
  got = t_kvc.pq_cache_prefill(kk, vv, w, cfg, use_kernel=True)
  # iters updates per window, for the key and the value codebooks
  assert len(calls) == cfg.pq.iters * n_windows * 2
  assert all(s == (b, h, m, cfg.window_len, d // m) for s in calls)
  calls.clear()
  want = t_kvc.pq_cache_prefill(kk, vv, w, cfg)
  assert not calls
  for f in got._fields:
    torch.testing.assert_close(getattr(got, f), getattr(want, f),
                               atol=0, rtol=0)


def test_tolerance_marks_empty_clusters():
  x, w, a, c = _case(9, 3, 50, 12, 2, "zero_w")
  tol, empty = t_b0.kmeans_update_tolerance(
      *[torch.from_numpy(v) for v in (x, w, a, c)])
  mass = np.stack([np.bincount(row, weights=wr, minlength=12)
                   for row, wr in zip(a, w)])
  np.testing.assert_array_equal(empty.numpy(), mass <= t_b0.EMPTY)
  assert empty.any() and (tol > 0).all()
  mag = np.zeros((3, 12, 2))
  for r in range(3):
    np.add.at(mag[r], a[r], np.abs(w[r, :, None] * x[r]))
  want = t_b0.REL_TOL * mag / np.maximum(mass, t_b0.EMPTY)[..., None] + \
      t_b0.ABS_TOL
  np.testing.assert_allclose(tol.numpy(), want, rtol=1e-5)


def test_wrapper_refuses_bad_shapes():
  x = torch.zeros(2, 8, 2)
  c = torch.zeros(2, 4, 2)
  w = torch.zeros(2, 8)
  a = torch.zeros(2, 8, dtype=torch.int32)
  with pytest.raises(ValueError, match="R, N, dsub"):
    t_b0.kmeans_update(x[0], w, a, c)
  with pytest.raises(ValueError, match="does not match"):
    t_b0.kmeans_update(x, w, a, torch.zeros(2, 4, 3))
  with pytest.raises(ValueError, match="must be"):
    t_b0.kmeans_update(x, w[:, :4], a, c)
