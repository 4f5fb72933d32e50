"""The port's contiguous KV caches against `repro.core.kv_cache`, with
per-request lengths: ragged PQ prefill, and plain and kernel-path decode
steps over a batch whose rows sit in the sink warm-up, in the ring, and past
the first eviction.  Float tolerance 1e-5 (f32 on the CPU); integer state
(ring contents selected by one-hot masks) exactly, and the indices of every
valid body row as `torch_parity.assert_pq_indices_match` states.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kv_cache as j_kvc
from repro.core import pq as j_pq
from repro_torch.core import kv_cache as t_kvc
from repro_torch.core import pq as t_pq
from torch_parity import assert_pq_indices_match

ATOL = RTOL = 1e-5
B, H, D, S0, R, NB, M, K = 3, 2, 16, 4, 8, 64, 4, 16


def _cfgs():
  j = j_kvc.PQCacheConfig(sink=S0, recent=R, body_capacity=NB,
                          pq=j_pq.PQConfig(m=M, k=K))
  t = t_kvc.PQCacheConfig(sink=S0, recent=R, body_capacity=NB,
                          pq=t_pq.PQConfig(m=M, k=K))
  return j, t


def _clustered_kv(rng, n):
  """K/V whose subvectors sit in K tight clusters: decisive assignments."""
  centers = rng.normal(size=(M, K, D // M)) * 3.0
  lab = rng.integers(0, K, size=(B, H, n, M))
  x = centers[np.arange(M), lab] + 0.02 * rng.normal(size=lab.shape +
                                                      (D // M,))
  return x.reshape(B, H, n, D).astype(np.float32)


def _compare_cache(t, j, exact_fields=(), body_len=None):
  for f in t._fields:
    a = getattr(t, f)
    r = np.asarray(getattr(j, f))
    if a.dtype in (torch.uint8, torch.int16):
      assert str(a.dtype) == f"torch.{r.dtype}"
      cbf = f.replace("indices", "codebooks")
      assert_pq_indices_match(
          r, a.numpy(), np.asarray(getattr(j, cbf)[:, :, 0].astype(
              jnp.float32)), body_len)
    elif f in exact_fields:
      np.testing.assert_array_equal(a.float().numpy(),
                                    r.astype(np.float32), err_msg=f)
    else:
      np.testing.assert_allclose(a.float().numpy(), r.astype(np.float32),
                                 atol=ATOL, rtol=2 ** -7, err_msg=f)


@pytest.mark.parametrize("lengths", [None, [60, 13, 40]])
def test_pq_prefill_matches_reference(lengths):
  rng = np.random.default_rng(0)
  n = 60
  k, v = _clustered_kv(rng, n), _clustered_kv(rng, n)
  w = rng.uniform(0.1, 1.0, size=(B, H, n)).astype(np.float32)
  jc, tc = _cfgs()
  ln = None if lengths is None else np.asarray(lengths, np.int32)
  body = np.clip((ln if ln is not None else np.full(B, n)) - S0 - R, 0, NB)
  j = j_kvc.pq_cache_prefill(jnp.asarray(k), jnp.asarray(v), jnp.asarray(w),
                             jc, length=None if ln is None else jnp.asarray(ln))
  t = t_kvc.pq_cache_prefill(torch.tensor(k), torch.tensor(v), torch.tensor(w),
                             tc, length=None if ln is None else torch.tensor(ln))
  _compare_cache(t, j, exact_fields=("sink_k", "sink_v", "recent_k",
                                     "recent_v"), body_len=body)


@pytest.mark.parametrize("kernel_path", [False, True])
def test_pq_decode_steps_match_reference(kernel_path):
  rng = np.random.default_rng(1)
  n = 60
  k, v = _clustered_kv(rng, n), _clustered_kv(rng, n)
  w = rng.uniform(0.1, 1.0, size=(B, H, n)).astype(np.float32)
  jc, tc = _cfgs()
  ln = np.asarray([2, 9, 43], np.int32)       # sink warm-up, ring, evicting
  j = j_kvc.pq_cache_prefill(jnp.asarray(k), jnp.asarray(v), jnp.asarray(w),
                             jc, length=jnp.asarray(ln))
  t = t_kvc.pq_cache_prefill(torch.tensor(k), torch.tensor(v),
                             torch.tensor(w), tc, length=torch.tensor(ln))
  for step in range(6):
    q = rng.normal(size=(B, 2 * H, D)).astype(np.float32)
    kn, vn = (_clustered_kv(rng, 1)[:, :, 0] for _ in range(2))
    args_j = (jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
              jnp.asarray(ln + step))
    args_t = (torch.tensor(q), torch.tensor(kn), torch.tensor(vn),
              torch.tensor(ln + step))
    if kernel_path:
      jo, j = j_kvc.pq_cache_append_and_attend_kernel(j, *args_j, jc, 0.25,
                                                      interpret=True)
      to, t = t_kvc.pq_cache_append_and_attend_kernel(t, *args_t, tc, 0.25)
    else:
      jo, j = j_kvc.pq_cache_append_and_attend(j, *args_j, jc, 0.25)
      to, t = t_kvc.pq_cache_append_and_attend(t, *args_t, tc, 0.25)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=RTOL)
    body = np.clip(ln + step + 1 - S0 - R, 0, NB)
    _compare_cache(t, j, exact_fields=("sink_k", "sink_v", "recent_k",
                                       "recent_v"), body_len=body)


@pytest.mark.parametrize("kernel_path", [False, True])
def test_exact_decode_steps_match_reference(kernel_path):
  rng = np.random.default_rng(2)
  n, cap = 20, 32
  k = rng.normal(size=(B, H, n, D)).astype(np.float32)
  v = rng.normal(size=(B, H, n, D)).astype(np.float32)
  j = j_kvc.exact_cache_prefill(jnp.asarray(k), jnp.asarray(v), cap)
  t = t_kvc.exact_cache_prefill(torch.tensor(k), torch.tensor(v), cap)
  ln = np.asarray([0, 7, 20], np.int32)
  for step in range(4):
    q = rng.normal(size=(B, 2 * H, D)).astype(np.float32)
    kn = rng.normal(size=(B, H, D)).astype(np.float32)
    vn = rng.normal(size=(B, H, D)).astype(np.float32)
    args_j = (jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
              jnp.asarray(ln + step))
    args_t = (torch.tensor(q), torch.tensor(kn), torch.tensor(vn),
              torch.tensor(ln + step))
    if kernel_path:
      jo, j = j_kvc.exact_cache_append_and_attend_kernel(j, *args_j, 0.25,
                                                         interpret=True)
      to, t = t_kvc.exact_cache_append_and_attend_kernel(t, *args_t, 0.25)
    else:
      jo, j = j_kvc.exact_cache_append_and_attend(j, *args_j, 0.25)
      to, t = t_kvc.exact_cache_append_and_attend(t, *args_t, 0.25)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=RTOL)
    _compare_cache(t, j, exact_fields=("k", "v"))


def test_index_storage_width_and_init_shapes():
  _, tc = _cfgs()
  assert t_kvc.index_storage_dtype(tc) == torch.uint8
  wide = tc._replace(pq=t_pq.PQConfig(m=M, k=512))
  assert t_kvc.index_storage_dtype(wide) == torch.int16
  c = t_kvc.pq_cache_init(B, H, D, wide, torch.float32)
  assert tuple(c.key_codebooks.shape) == (B, H, 1, M, 512, D // M)
  assert c.key_codebooks.dtype == torch.bfloat16
  assert tuple(c.key_indices.shape) == (B, H, NB, M)
  np.testing.assert_array_equal(
      t_kvc.as_lengths(5, 3).numpy(),
      np.asarray(j_kvc.as_lengths(5, 3)))
