"""PQ math of the port against the reference: k-means, codebook builds,
windowed build and encode, Eq. 1 importance weights and the PQ attention
paths.  Inputs come from numpy seeds and go through both packages.

Assignments must be equal exactly.  Every case first asserts that, on the
reference's own result, each row's nearest centroid beats every other
(distinct) centroid by a gap far above f32 rounding, so a failure reads as
a real difference and not as a near tie.  Floats: 1e-5 (f32 on the CPU,
sums taken in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import importance as j_imp
from repro.core import kmeans as j_km
from repro.core import pq as j_pq
from repro.core import pq_attention as j_pqa
from repro.core import windowed as j_win
from repro_torch.core import importance as t_imp
from repro_torch.core import kmeans as t_km
from repro_torch.core import pq as t_pq
from repro_torch.core import pq_attention as t_pqa
from repro_torch.core import windowed as t_win

ATOL = RTOL = 1e-5
MIN_GAP = 1e-5   # squared-distance gap, relative: ~100x f32 rounding (1.2e-7)


def _t(a):
  return torch.from_numpy(np.array(a))


def _clustered(rng, n, k, dsub, spread=0.05):
  centers = rng.normal(size=(k, dsub)) * 3.0
  labels = rng.integers(0, k, size=n)
  return (centers[labels] + spread * rng.normal(size=(n, dsub))).astype(
      np.float32)


def _assert_same_assignment(x, cb_ref, idx_ref, idx_port):
  """x (N, dsub), cb_ref (K, dsub), idx (N,): the port picks the reference's
  centroid, and the reference's pick is decisive."""
  x = np.asarray(x, np.float64)
  cb = np.asarray(cb_ref, np.float64)
  idx_ref = np.asarray(idx_ref).astype(np.int64)
  idx_port = np.asarray(idx_port).astype(np.int64)
  d2 = ((x[:, None, :] - cb[None]) ** 2).sum(-1)               # (N, K)
  chosen = cb[idx_ref]
  same = (np.asarray(cb_ref)[None] == np.asarray(cb_ref)[idx_ref][:, None]
          ).all(-1)                                            # duplicates
  best = d2[np.arange(len(x)), idx_ref]
  other = np.where(same, np.inf, d2).min(-1)
  assert np.all(other - best > MIN_GAP * (1.0 + best)), \
      "seeded inputs have a near tie: pick another seed"
  np.testing.assert_array_equal(cb[idx_port], chosen)
  unique = same.sum(-1) == 1
  np.testing.assert_array_equal(idx_port[unique], idx_ref[unique])


@pytest.mark.parametrize("seed,masked", [
    (0, False), (1, False), (2, False), (0, True), (5, True)])
def test_weighted_kmeans_matches_reference(seed, masked):
  rng = np.random.default_rng(seed)
  n, k, dsub = 96, 16, 4
  x = _clustered(rng, n, k, dsub)
  w = rng.uniform(0.1, 2.0, size=n).astype(np.float32)
  mask = np.arange(n) < 70 if masked else None
  jc, ja = j_km.weighted_kmeans(
      jnp.asarray(x), jnp.asarray(w), k=k,
      mask=None if mask is None else jnp.asarray(mask))
  tc, ta = t_km.weighted_kmeans(
      _t(x), _t(w), k, mask=None if mask is None else _t(mask))
  assert ta.dtype == torch.int32 and tuple(ta.shape) == (n,)
  _assert_same_assignment(x, jc, ja, ta.numpy())
  np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_sq_dists_matches_reference(seed):
  rng = np.random.default_rng(seed)
  x = rng.normal(size=(33, 4)).astype(np.float32)
  c = rng.normal(size=(16, 4)).astype(np.float32)
  np.testing.assert_allclose(
      t_km.pairwise_sq_dists(_t(x), _t(c)).numpy(),
      np.asarray(j_km.pairwise_sq_dists(jnp.asarray(x), jnp.asarray(c))),
      atol=ATOL, rtol=RTOL)


def _subvector_data(rng, n, m, k, dsub):
  return np.concatenate([_clustered(rng, n, k, dsub) for _ in range(m)],
                        axis=1)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_build_codebook_matches_reference(seed, warm):
  rng = np.random.default_rng(seed)
  n, m, k, dsub = 80, 4, 16, 4
  x = _subvector_data(rng, n, m, k, dsub)
  w = rng.uniform(0.1, 2.0, size=n).astype(np.float32)
  mask = np.arange(n) < 64
  cfg_j, cfg_t = j_pq.PQConfig(m=m, k=k), t_pq.PQConfig(m=m, k=k)
  init = None
  if warm:
    init = np.stack([_clustered(rng, k, k, dsub, spread=0.5)
                     for _ in range(m)])
  jc, ji = j_pq.build_codebook(
      jnp.asarray(x), jnp.asarray(w), cfg_j, mask=jnp.asarray(mask),
      init_codebook=None if init is None else jnp.asarray(init))
  tc, ti = t_pq.build_codebook(
      _t(x), _t(w), cfg_t, mask=_t(mask),
      init_codebook=None if init is None else _t(init))
  assert tuple(ti.shape) == (n, m) and ti.dtype == torch.int32
  np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL,
                             rtol=RTOL)
  xs = x.reshape(n, m, dsub)
  for j in range(m):
    _assert_same_assignment(xs[:, j], np.asarray(jc)[j], np.asarray(ji)[:, j],
                            ti.numpy()[:, j])


@pytest.mark.parametrize("n_windows", [1, 2])
def test_windowed_build_and_encode_match_reference(n_windows):
  rng = np.random.default_rng(5)
  n, m, k, dsub = 128, 4, 16, 4
  x = _subvector_data(rng, n, m, k, dsub)
  w = rng.uniform(0.1, 2.0, size=n).astype(np.float32)
  mask = np.arange(n) < 120
  cfg_j, cfg_t = j_pq.PQConfig(m=m, k=k), t_pq.PQConfig(m=m, k=k)
  jc, ji = j_win.windowed_build_codebooks(
      jnp.asarray(x), jnp.asarray(w), cfg_j, n_windows, mask=jnp.asarray(mask))
  tc, ti = t_win.windowed_build_codebooks(_t(x), _t(w), cfg_t, n_windows,
                                          mask=_t(mask))
  np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL,
                             rtol=RTOL)
  w_len = n // n_windows
  xs = x.reshape(n, m, dsub)
  for win in range(n_windows):
    rows = slice(win * w_len, (win + 1) * w_len)
    for j in range(m):
      _assert_same_assignment(xs[rows, j], np.asarray(jc)[win, j],
                              np.asarray(ji)[rows, j], ti.numpy()[rows, j])

  # decode-time encode of fresh tokens against their window's page
  xe = _subvector_data(rng, 12, m, k, dsub)
  wid = rng.integers(0, n_windows, size=12).astype(np.int32)
  je = j_win.windowed_encode(jnp.asarray(xe), jc, jnp.asarray(wid))
  cb_t = _t(jc)
  te = t_win.windowed_encode(_t(xe), cb_t.expand(12, *cb_t.shape), _t(wid))
  xes = xe.reshape(12, m, dsub)
  for i in range(12):
    for j in range(m):
      _assert_same_assignment(xes[i:i + 1, j], np.asarray(jc)[wid[i], j],
                              np.asarray(je)[i:i + 1, j], te.numpy()[i:i + 1, j])


@pytest.mark.parametrize("length", [None, 29, 5])
def test_importance_weights_match_reference(length):
  rng = np.random.default_rng(7)
  n, d, t = 40, 16, 8
  q = rng.normal(size=(n, d)).astype(np.float32)
  k = rng.normal(size=(n, d)).astype(np.float32)
  scale = d ** -0.5
  jw = j_imp.attention_importance_weights(
      jnp.asarray(q), jnp.asarray(k), scale, t=t, chunk=16,
      length=None if length is None else jnp.asarray(length, jnp.int32))
  tw = t_imp.attention_importance_weights(
      _t(q), _t(k), scale, t=t, chunk=16,
      length=None if length is None else torch.tensor(length))
  np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL,
                             rtol=RTOL)


def _segments(rng, g, d, m, k, n, s0, r, body_len, n_windows=1):
  dsub = d // m
  f32 = np.float32
  cb_shape = ((n_windows,) if n_windows > 1 else ()) + (m, k, dsub)
  return dict(
      q=rng.normal(size=(g, d)).astype(f32),
      sink_k=rng.normal(size=(s0, d)).astype(f32),
      sink_v=rng.normal(size=(s0, d)).astype(f32),
      sink_mask=np.arange(s0) < s0 - 1,
      key_codebook=rng.normal(size=cb_shape).astype(f32),
      value_codebook=rng.normal(size=cb_shape).astype(f32),
      key_indices=rng.integers(0, k, size=(n, m)).astype(np.int32),
      value_indices=rng.integers(0, k, size=(n, m)).astype(np.int32),
      body_mask=np.arange(n) < body_len,
      recent_k=rng.normal(size=(r, d)).astype(f32),
      recent_v=rng.normal(size=(r, d)).astype(f32),
      recent_mask=np.arange(r) < r - 2)


@pytest.mark.parametrize("value_mode,n_windows", [
    ("bucket", 1), ("reconstruct", 1), ("bucket", 2)])
def test_pq_decode_attention_matches_reference(value_mode, n_windows):
  rng = np.random.default_rng(11)
  g, d, m, k, n = 3, 16, 4, 16, 64
  seg = _segments(rng, g, d, m, k, n, 4, 8, 41, n_windows)
  q = seg.pop("q")
  scale = d ** -0.5
  jo = j_pqa.pq_decode_attention(
      jnp.asarray(q),
      j_pqa.PQAttnSegments(**{kk: jnp.asarray(v) for kk, v in seg.items()}),
      scale, value_mode=value_mode)
  to = t_pqa.pq_decode_attention(
      _t(q), t_pqa.PQAttnSegments(**{kk: _t(v) for kk, v in seg.items()}),
      scale, value_mode=value_mode)
  np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                             rtol=RTOL)


def test_table_lookup_reconstruct_match_reference():
  rng = np.random.default_rng(13)
  g, d, m, k, n = 4, 16, 4, 16, 50
  q = rng.normal(size=(g, d)).astype(np.float32)
  cb = rng.normal(size=(m, k, d // m)).astype(np.float32)
  idx = rng.integers(0, k, size=(n, m)).astype(np.int32)
  jt = j_pqa.inner_product_table(jnp.asarray(q), jnp.asarray(cb))
  tt = t_pqa.inner_product_table(_t(q), _t(cb))
  np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL, rtol=RTOL)
  np.testing.assert_allclose(
      t_pqa.lookup_scores(tt, _t(idx)).numpy(),
      np.asarray(j_pqa.lookup_scores(jt, jnp.asarray(idx))),
      atol=ATOL, rtol=RTOL)
  np.testing.assert_array_equal(
      t_pqa.reconstruct_values(_t(idx), _t(cb)).numpy(),
      np.asarray(j_pqa.reconstruct_values(jnp.asarray(idx), jnp.asarray(cb))))
  p = rng.uniform(size=(g, n)).astype(np.float32)
  jb = j_pqa.bucket_accumulate(jnp.asarray(p), jnp.asarray(idx), k)
  tb = t_pqa.bucket_accumulate(_t(p), _t(idx), k)
  np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL, rtol=RTOL)
  np.testing.assert_allclose(
      t_pqa.output_from_buckets(tb, _t(cb)).numpy(),
      np.asarray(j_pqa.output_from_buckets(jb, jnp.asarray(cb))),
      atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n_valid", [0, 1, 7])
def test_segment_attention_stats_matches_reference(n_valid):
  rng = np.random.default_rng(17)
  g, s, d = 3, 7, 16
  q = rng.normal(size=(g, d)).astype(np.float32)
  k = rng.normal(size=(s, d)).astype(np.float32)
  v = rng.normal(size=(s, d)).astype(np.float32)
  mask = np.arange(s) < n_valid
  jr = j_pqa.segment_attention_stats(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(mask), 0.25)
  tr = t_pqa.segment_attention_stats(_t(q), _t(k), _t(v), _t(mask), 0.25)
  for a, b in zip(tr, jr):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL)
