"""The packed resident exact store (`kv_resident_codec` q4/q5/q8) of the port
against the reference's, on the CPU.

  - a config that asks for `exact` with a resident codec builds the packed
    policy in both packages, with equal `bytes()`;
  - the plain K5 against `packed_paged_flash_decode_kernel(interpret=True)`
    at `layer = L - 1`, shuffled tables with trash entries past each length,
    lengths 0 and full, for bits 4, 5 and 8 (tolerance 1e-5: f32, same
    inputs, sums in another order);
  - `packed_exact_cache_append_and_attend` (plain path and the kernel path's
    composition, whose K8/K2 wrappers take their plain versions on CPU
    tensors) and `packed_exact_cache_paged_step` against the reference's:
    outputs within 1e-5, the packed store and pools exactly equal (outside
    the trash block, which nothing reads);
  - greedy q4 tokens equal to the reference's on the paged `ServeEngine`
    (the reference's own q4 trace) and through `Model.prefill` plus
    `decode_step` on the contiguous layout.

The CUDA legs (K5 and K8 against their plain versions on the card) are in
`test_torch_cuda_kernels.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import kv_cache as j_kvc
from repro.kernels import packing as j_pk
from repro.kernels import paged_flash_decode as j_pfd
from repro.launch.engine import ServeEngine as JEngine
from repro.models.model import Model as JModel
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.core import cache_api as t_cache_api
from repro_torch.core import decode_dispatch
from repro_torch.core import kv_cache as t_kvc
from repro_torch.kernels import paged_flash_decode as t_pfd
from repro_torch.launch.engine import ServeEngine as TEngine
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model as TModel

ARCH = "tinyllama-1.1b"
ATOL = RTOL = 1e-5
BITS = [4, 5, 8]


def _cfgs(**kw):
  kw = dict(cache_policy="exact", dtype_str="float32", **kw)
  return (dataclasses.replace(j_get_arch(ARCH, reduced=True), **kw),
          dataclasses.replace(t_get_arch(ARCH, reduced=True), **kw))


def _tables(rng, b, nb, blk, pool_blocks, lengths):
  """(B, nb) int32: shuffled pool ids, trash (= pool_blocks) past each
  row's length."""
  tables = rng.permutation(pool_blocks)[:b * nb].reshape(b, nb)
  used = -(-np.asarray(lengths) // blk)
  tables = np.where(np.arange(nb)[None, :] >= used[:, None], pool_blocks,
                    tables)
  return tables.astype(np.int32)


def _packed_pools(rng, shape, d, bits):
  """Six pools (codes, scale, min for K and V) of (P+1, L, H, blk, x),
  quantized from normal draws by the reference's encoder."""
  group = j_pk.group_size(d)
  pools = []
  for _ in range(2):
    x = rng.normal(scale=1.5, size=shape + (d,)).astype(np.float32)
    pools += [np.asarray(a) for a in
              j_pk.pack_rows(jnp.asarray(x), bits=bits, group=group)]
  return pools


@pytest.mark.parametrize("codec", ["q4", "q5", "q8"])
def test_exact_with_resident_codec_builds_packed_policy(codec):
  jcfg, tcfg = _cfgs(kv_resident_codec=codec)
  jp, tp = jcfg.make_cache_policy(64), tcfg.make_cache_policy(64)
  assert type(jp).__name__ == type(tp).__name__ == "PackedExactPolicy"
  assert isinstance(tp, t_cache_api.ExactPolicy) and tp.name == "exact"
  assert tp.bits == jp.bits
  assert tp.bytes(2, 2, 16) == jp.bytes(2, 2, 16)
  assert tp.bytes(4, 4, 64) == jp.bytes(4, 4, 64)
  assert not tp.prefix_shareable
  assert tuple(tp.paged_axes()) == tuple(jp.paged_axes())
  assert tuple(tp.spill_codecs()) == tuple(jp.spill_codecs())
  state = tp.init(2, 2, 16)
  ref = jp.init(2, 2, 16)
  for f in state._fields:
    assert tuple(getattr(state, f).shape) == getattr(ref, f).shape
    assert str(getattr(state, f).dtype) == f"torch.{getattr(ref, f).dtype}"


def test_resident_codec_none_keeps_dense_exact_and_bad_keys_raise():
  _, tcfg = _cfgs()
  assert type(tcfg.make_cache_policy(64)) is t_cache_api.ExactPolicy
  with pytest.raises(ValueError, match=r"\('none', 'q4', 'q5', 'q8'\)"):
    t_cache_api.CacheSpec(capacity=64, head_dim=16, kv_resident_codec="q3")


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("lengths", [[0, "full"], [23, 7]])
def test_plain_k5_matches_interpret_kernel(bits, lengths):
  b, h, g, d, blk, nb, n_layers = 2, 2, 2, 16, 4, 6, 3
  rng = np.random.default_rng(bits)
  pool_blocks = 3 * nb
  lengths = np.asarray([nb * blk if x == "full" else x for x in lengths],
                       np.int32)
  tables = _tables(rng, b, nb, blk, pool_blocks, lengths)
  q = rng.normal(size=(b * h, g, d)).astype(np.float32)
  pools = _packed_pools(rng, (pool_blocks + 1, n_layers, h, blk), d, bits)
  layer, scale = n_layers - 1, d ** -0.5

  before = t_pfd.packed_paged_flash_decode.launches
  out = t_pfd.packed_paged_flash_decode(
      torch.tensor(q), *[torch.tensor(p) for p in pools],
      torch.tensor(tables), layer, torch.tensor(lengths), scale, bits)
  assert t_pfd.packed_paged_flash_decode.launches == before
  ref = j_pfd.packed_paged_flash_decode_kernel(
      jnp.asarray(q), *[jnp.asarray(p) for p in pools],
      jnp.asarray(np.repeat(tables, h, axis=0)),
      jnp.asarray([layer], jnp.int32), jnp.asarray(np.repeat(lengths, h)),
      scale=scale, bits=bits, interpret=True)
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                             rtol=RTOL)
  if lengths[0] == 0:
    assert np.all(out[:h].numpy() == 0)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_packed_append_and_attend_matches_reference(bits, use_kernel):
  rng = np.random.default_rng(10 + bits)
  b, h, hq, d, n, n_max = 3, 2, 4, 16, 9, 12
  k = rng.normal(size=(b, h, n, d)).astype(np.float32)
  v = rng.normal(size=(b, h, n, d)).astype(np.float32)
  q = rng.normal(size=(b, hq, d)).astype(np.float32)
  k_new = rng.normal(size=(b, h, d)).astype(np.float32)
  v_new = rng.normal(size=(b, h, d)).astype(np.float32)
  lengths = np.asarray([0, 5, 9], np.int32)
  scale = d ** -0.5
  cache = t_kvc.packed_exact_cache_prefill(torch.tensor(k), torch.tensor(v),
                                           n_max, bits)
  ref_cache = j_kvc.packed_exact_cache_prefill(jnp.asarray(k), jnp.asarray(v),
                                               n_max, bits)
  for a, e in zip(cache, ref_cache):
    np.testing.assert_array_equal(a.numpy(), np.asarray(e))
  out, cache = t_kvc.packed_exact_cache_append_and_attend(
      cache, torch.tensor(q), torch.tensor(k_new), torch.tensor(v_new),
      torch.tensor(lengths), scale, bits, use_kernel=use_kernel)
  r_out, ref_cache = j_kvc.packed_exact_cache_append_and_attend(
      ref_cache, jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
      jnp.asarray(lengths), scale, bits)
  np.testing.assert_allclose(out.numpy(), np.asarray(r_out), atol=ATOL,
                             rtol=RTOL)
  for a, e in zip(cache, ref_cache):
    np.testing.assert_array_equal(a.numpy(), np.asarray(e))
  kd, vd = t_kvc.packed_exact_dequant(cache, bits, use_kernel)
  rkd, rvd = j_kvc.packed_exact_dequant(ref_cache, bits)
  np.testing.assert_array_equal(kd.numpy(), np.asarray(rkd))
  np.testing.assert_array_equal(vd.numpy(), np.asarray(rvd))


@pytest.mark.parametrize("bits", BITS)
def test_packed_paged_step_matches_reference(bits):
  rng = np.random.default_rng(20 + bits)
  b, h, hq, d, blk, nb, n_layers = 3, 2, 4, 16, 4, 5, 3
  pool_blocks = 3 * nb
  lengths = np.asarray([0, 7, 19], np.int32)
  tables = _tables(rng, b, nb, blk, pool_blocks, lengths + 1)
  pools = _packed_pools(rng, (pool_blocks + 1, n_layers, h, blk), d, bits)
  q = rng.normal(size=(b, hq, d)).astype(np.float32)
  k_new = rng.normal(size=(b, h, d)).astype(np.float32)
  v_new = rng.normal(size=(b, h, d)).astype(np.float32)
  layer, scale = n_layers - 1, d ** -0.5
  out, got = t_kvc.packed_exact_cache_paged_step(
      [torch.tensor(p) for p in pools], layer, torch.tensor(tables),
      torch.tensor(q), torch.tensor(k_new), torch.tensor(v_new),
      torch.tensor(lengths), scale, bits)
  r_out, ref = j_kvc.packed_exact_cache_paged_step(
      [jnp.asarray(p) for p in pools], jnp.asarray(layer, jnp.int32),
      jnp.asarray(tables), jnp.asarray(q), jnp.asarray(k_new),
      jnp.asarray(v_new), jnp.asarray(lengths), scale, bits, interpret=True)
  np.testing.assert_allclose(out.numpy(), np.asarray(r_out), atol=ATOL,
                             rtol=RTOL)
  for a, e, p in zip(got, ref, pools):
    np.testing.assert_array_equal(a.numpy()[:pool_blocks],
                                  np.asarray(e)[:pool_blocks])
  # every request wrote its new row into its mapped block
  assert not np.array_equal(got[0].numpy()[:pool_blocks],
                            pools[0][:pool_blocks])


@pytest.mark.parametrize("native", [False, True])
def test_q4_engine_tokens_match_reference(native):
  """The reference's own q4 trace (two requests of 20 and 22 prompt tokens,
  14 new each, a 12-block pool).  `native` runs the port's block-native
  program (K5's wrapper, which takes its plain version on CPU tensors)
  against the reference's dense program."""
  jcfg, tcfg = _cfgs(kv_resident_codec="q4", cache_layout="paged",
                     scheduler="paged")
  je = JEngine(dataclasses.replace(jcfg, decode_kernel="xla"),
               context_len=64, max_batch=2, prompt_capacity=32, num_blocks=12)
  model = TModel(dataclasses.replace(tcfg, decode_kernel="torch"),
                 context_len=64, device="cpu")
  params_from_numpy(model, jax.tree_util.tree_map(np.asarray, je.params))
  if native:
    model.cache_policy.dispatch = decode_dispatch.DecodeDispatch("cuda", True)
  te = TEngine(model.cfg, context_len=64, max_batch=2, prompt_capacity=32,
               model=model, num_blocks=12)
  assert te.layout.block_native == native
  assert type(model.cache_policy).__name__ == "PackedExactPolicy"
  trace = [(list(range(1, 21)), 14), (list(range(3, 25)), 14)]
  want = [je.submit(p, max_new_tokens=m) for p, m in trace]
  got = [te.submit(p, max_new_tokens=m) for p, m in trace]
  je.run_to_completion()
  te.run_to_completion()
  for w, g in zip(want, got):
    assert g.done and g.tokens == w.tokens, g.rid
  assert te.kv_bytes()["block_bytes"] == je.kv_bytes()["block_bytes"]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_q4_model_tokens_contiguous_match_reference(use_kernel):
  """Model.prefill + 8 greedy decode steps, q4, contiguous layout: logits
  within 1e-4, the greedy tokens equal at every step, the packed store
  equal."""
  bsz, s, gen = 2, 40, 8
  jcfg, tcfg = _cfgs(kv_resident_codec="q4", decode_kernel="xla")
  jm = JModel(jcfg, context_len=s + gen)
  params = jm.init(jax.random.PRNGKey(0))
  tm = TModel(dataclasses.replace(tcfg, decode_kernel="torch"),
              context_len=s + gen, device="cpu")
  params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, params))
  if use_kernel:
    tm.cache_policy.dispatch = decode_dispatch.DecodeDispatch("cuda", True)
  toks = np.random.default_rng(0).integers(0, 256, size=(bsz, s)).astype(
      np.int32)
  jl, jc = jax.jit(jm.prefill)(params, jnp.asarray(toks))
  tl, tc = tm.prefill(torch.tensor(toks))
  step = jax.jit(jm.decode_step)
  tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
  for i in range(gen):
    ln = np.full((bsz,), s + i, np.int32)
    jl, jc = step(params, jnp.asarray(tok), jc, jnp.asarray(ln))
    tl, tc = tm.decode_step(torch.tensor(tok), tc, torch.tensor(ln))
    ref = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tl.numpy().argmax(-1), ref.argmax(-1))
    tok = ref.argmax(-1).astype(np.int32)
  for li in range(len(tc)):
    for f in tc[li]._fields:
      np.testing.assert_array_equal(getattr(tc[li], f).numpy(),
                                    np.asarray(getattr(jc, f)[li]))
