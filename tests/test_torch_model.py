"""The port's model against the reference's, reduced tinyllama in f32.

Params come from the reference's `Model.init(PRNGKey(0))` and go through
`params_from_numpy`; prompts come from a numpy seed.  Checked:

  - prefill logits (1e-4: f32 on the CPU, sums in another order);
  - the PQ caches: sink and recent rings (1e-5, the projections' rounding),
    codebooks (bf16 storage: equal to one bf16 step), and the indices of
    every valid body row exactly.  A row's index may differ only where the
    reference's codebook holds bit-identical copies of the chosen centroid
    (masked rows collapse onto row 0 at init): then the decoded centroid is
    asserted equal instead.  Rows past the prompt's body are padding that
    the decode masks and later overwrites, and are not compared;
  - 8 teacher-forced decode steps for `exact` and `pq`: logits within 1e-4
    of `Model.decode_step` under `xla` (against the port's plain path) and
    under `pallas-interpret` (against the port's kernel path, whose kernel
    wrappers take their plain versions on CPU tensors); greedy tokens equal
    wherever the reference's top-2 margin exceeds the tolerance; the cache's
    integer ring state (indices) equal as above after the steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models.model import Model as JModel
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.core import decode_dispatch
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model as TModel
from torch_parity import assert_pq_indices_match

ARCH = "tinyllama-1.1b"
B, S, GEN = 2, 48, 8
ATOL = RTOL = 1e-4


def _models(policy, jax_kernel):
  ctx = S + GEN
  jcfg = dataclasses.replace(j_get_arch(ARCH, reduced=True),
                             cache_policy=policy, decode_kernel=jax_kernel)
  tcfg = dataclasses.replace(t_get_arch(ARCH, reduced=True),
                             cache_policy=policy, decode_kernel="torch")
  jm = JModel(jcfg, context_len=ctx)
  params = jm.init(jax.random.PRNGKey(0))
  tm = TModel(tcfg, context_len=ctx, device="cpu")
  params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, params))
  if jax_kernel != "xla":
    # the kernel path's composition (ring step, K1/K2 wrappers, combine);
    # the wrappers take their plain versions because the tensors are on CPU
    tm.cache_policy.dispatch = decode_dispatch.DecodeDispatch("cuda", True)
  return jm, params, tm


def _prompts():
  rng = np.random.default_rng(0)
  return rng.integers(0, 256, size=(B, S)).astype(np.int32)


def _assert_pq_cache(j_cache, t_cache, body_len):
  for li in range(len(t_cache)):
    for f in ("sink_k", "sink_v", "recent_k", "recent_v"):
      np.testing.assert_allclose(getattr(t_cache[li], f).numpy(),
                                 np.asarray(getattr(j_cache, f)[li]),
                                 atol=1e-5, rtol=1e-5)
    for f in ("key_codebooks", "value_codebooks"):
      np.testing.assert_allclose(
          getattr(t_cache[li], f).float().numpy(),
          np.asarray(getattr(j_cache, f)[li].astype(jnp.float32)),
          atol=1e-5, rtol=2 ** -7)
  for li in range(len(t_cache)):
    for f, cbf in (("key_indices", "key_codebooks"),
                   ("value_indices", "value_codebooks")):
      ref = np.asarray(getattr(j_cache, f)[li])
      got = getattr(t_cache[li], f)
      assert str(got.dtype) == f"torch.{ref.dtype}"
      assert_pq_indices_match(
          ref, got.numpy(),
          np.asarray(getattr(j_cache, cbf)[li].astype(jnp.float32))[:, :, 0],
          body_len)


@pytest.mark.parametrize("policy", ["pq", "exact"])
def test_prefill_matches_reference(policy):
  jm, params, tm = _models(policy, "xla")
  toks = _prompts()
  jl, jc = jax.jit(jm.prefill)(params, jnp.asarray(toks))
  tl, tc = tm.prefill(torch.tensor(toks))
  np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)
  if policy == "pq":
    _assert_pq_cache(jc, tc, [S - 12] * B)
  else:
    for li in range(len(tc)):
      np.testing.assert_allclose(tc[li].k.numpy(), np.asarray(jc.k[li]),
                                 atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("jax_kernel", ["xla", "pallas-interpret"])
@pytest.mark.parametrize("policy", ["pq", "exact"])
def test_teacher_forced_decode_matches_reference(policy, jax_kernel):
  jm, params, tm = _models(policy, jax_kernel)
  toks = _prompts()
  jl, jc = jax.jit(jm.prefill)(params, jnp.asarray(toks))
  tl, tc = tm.prefill(torch.tensor(toks))
  step = jax.jit(jm.decode_step)
  tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
  for i in range(GEN):
    ln = np.full((B,), S + i, np.int32)
    jl, jc = step(params, jnp.asarray(tok), jc, jnp.asarray(ln))
    tl, tc = tm.decode_step(torch.tensor(tok), tc, torch.tensor(ln))
    ref = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), ref, atol=ATOL, rtol=RTOL)
    top2 = np.sort(ref, axis=-1)[:, -2:]
    decisive = top2[:, 1] - top2[:, 0] > ATOL
    np.testing.assert_array_equal(tl.numpy().argmax(-1)[decisive],
                                  ref.argmax(-1)[decisive])
    tok = ref.argmax(-1).astype(np.int32)
  if policy == "pq":
    _assert_pq_cache(jc, tc, [S + GEN - 12] * B)


def test_ragged_prefill_matches_reference():
  jm, params, tm = _models("pq", "xla")
  toks = _prompts()
  lengths = np.asarray([S, 31], np.int32)
  jl, jc = jax.jit(jm.prefill)(params, jnp.asarray(toks), None,
                               jnp.asarray(lengths))
  tl, tc = tm.prefill(torch.tensor(toks), torch.tensor(lengths))
  np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)
  _assert_pq_cache(jc, tc, np.clip(lengths - 12, 0, None))


@pytest.mark.parametrize("policy", ["pq", "exact"])
def test_init_cache_matches_reference(policy):
  jm, _, tm = _models(policy, "xla")
  jc = jm.init_cache(B)
  tc = tm.init_cache(B)
  assert len(tc) == tm.cfg.n_layers
  for f in tc[0]._fields:
    ref = np.asarray(getattr(jc, f))
    got = getattr(tc[0], f)
    assert tuple(got.shape) == ref.shape[1:], f
    assert str(got.dtype) == f"torch.{ref.dtype}", f
    assert not got.float().any()
