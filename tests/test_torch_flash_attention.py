"""K7 (flash attention) and `Model.forward` of the port against the
reference.

  - `flash_attention_plain` against the reference's Pallas kernel
    (`repro.kernels.ops.flash_attention`, interpret mode on the CPU) and its
    oracle `ref.flash_attention_ref`, at `tests/test_kernels.py`'s shapes
    and tolerances (2e-3 for f32, 3e-2 for bf16; causal and not);
  - a ragged N, which the TPU kernel refuses: against the oracle and the
    port's `chunked_attention` (1e-5: f32 on the CPU, sums in another
    order);
  - the K7 wrapper on CPU tensors is its plain version and launches nothing;
  - `Model.forward` logits against the reference's `Model.forward` on
    reduced tinyllama in f32, unsharded params (1e-4, as the prefill
    parity of `test_torch_model.py`), where the reference takes its flash
    route and where it takes its chunked one, and through the `cuda`
    routing (K7's wrapper, which takes its plain version on the CPU);
  - under `cuda` every sequence length goes to K7's wrapper, ragged ones
    too; under `torch` none does.

Inputs come from numpy seeds.  The kernel's own legs run on the card
(`test_torch_cuda_kernels.py`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models.model import Model as JModel
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.core import decode_dispatch
from repro_torch.kernels import flash_attention as t_k7
from repro_torch.kernels import ops as t_ops
from repro_torch.models import layers as t_layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model as TModel

ARCH = "tinyllama-1.1b"


def _qkv(seed, b, hq, hkv, n, d):
  rng = np.random.default_rng(seed)
  return (rng.normal(size=(b, hq, n, d)).astype(np.float32),
          rng.normal(size=(b, hkv, n, d)).astype(np.float32),
          rng.normal(size=(b, hkv, n, d)).astype(np.float32))


def _both(arrays, jdtype, tdtype):
  return ([jnp.asarray(a, jdtype) for a in arrays],
          [torch.from_numpy(a).to(tdtype) for a in arrays])


@pytest.mark.parametrize("b,hq,hkv,n,d,blk", [
    (1, 1, 1, 128, 32, 64),
    (2, 4, 2, 256, 64, 64),
    (1, 8, 1, 256, 16, 128),     # MQA
    (2, 6, 6, 192, 32, 64),      # MHA, n not a power of two
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_kernel_and_oracle(b, hq, hkv, n, d, blk,
                                                   causal):
  (jq, jk, jv), (tq, tk, tv) = _both(_qkv(n + hq, b, hq, hkv, n, d),
                                     jnp.float32, torch.float32)
  scale = 1 / np.sqrt(d)
  got = t_k7.flash_attention_plain(tq, tk, tv, scale, causal, blk).numpy()
  kern = j_ops.flash_attention(jq, jk, jv, scale, causal=causal, blk_q=blk,
                               blk_k=blk)
  oracle = j_ref.flash_attention_ref(jq, jk, jv, scale, causal=causal)
  np.testing.assert_allclose(got, np.asarray(kern), rtol=2e-3, atol=2e-3)
  np.testing.assert_allclose(got, np.asarray(oracle), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("jdtype,tdtype,tol", [
    (jnp.float32, torch.float32, 2e-3), (jnp.bfloat16, torch.bfloat16, 3e-2)])
def test_plain_dtypes_match_reference(jdtype, tdtype, tol):
  (jq, jk, jv), (tq, tk, tv) = _both(_qkv(8, 1, 2, 2, 128, 32), jdtype,
                                     tdtype)
  got = t_k7.flash_attention_plain(tq, tk, tv, 0.18, True, 64)
  assert got.dtype == tdtype
  kern = j_ops.flash_attention(jq, jk, jv, 0.18, blk_q=64, blk_k=64)
  oracle = j_ref.flash_attention_ref(jq, jk, jv, 0.18)
  for want in (kern, oracle):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("n,blk", [(100, 32), (1000, 256), (1, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_ragged_n_matches_oracle_and_chunked(n, blk, causal):
  (jq, jk, jv), (tq, tk, tv) = _both(_qkv(n, 2, 4, 2, n, 16), jnp.float32,
                                     torch.float32)
  got = t_k7.flash_attention_plain(tq, tk, tv, 0.25, causal, blk)
  oracle = j_ref.flash_attention_ref(jq, jk, jv, 0.25, causal=causal)
  np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5,
                             atol=1e-5)
  if causal:
    chunked = t_layers.chunked_attention(tq, tk, tv, 0.25, blk=64)
    np.testing.assert_allclose(got.numpy(), chunked.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("g", list(range(1, 33)) + [48, 64])
def test_block_geometry_fills_a_block_with_one_group(g, d):
  hb, pt = t_k7.block_geometry(g, d)
  rows = t_k7.WGMMA_ROWS if d == 64 else t_k7.MMA_ROWS
  assert hb in (1, 2, 4, 8) and g % hb == 0
  assert hb * pt == rows and pt % 16 == 0
  # the largest power of two that divides g and fits: the most K/V reuse
  assert all(g % h for h in (8, 4, 2) if hb < h <= rows // 16)


def test_wrapper_on_cpu_is_the_plain_version():
  _, (tq, tk, tv) = _both(_qkv(3, 2, 4, 2, 96, 16), jnp.float32,
                          torch.float32)
  before = t_k7.flash_attention.launches
  for causal in (True, False):
    got = t_k7.flash_attention(tq, tk, tv, 0.25, causal)
    assert torch.equal(got, t_k7.flash_attention_plain(tq, tk, tv, 0.25,
                                                       causal))
  # ops takes strided views (the projections' transposes) as they come
  got = t_ops.flash_attention(tq.transpose(2, 3).contiguous().transpose(2, 3),
                              tk, tv, 0.25)
  assert torch.equal(got, t_k7.flash_attention_plain(tq, tk, tv, 0.25))
  assert t_k7.flash_attention.launches == before
  with pytest.raises(ValueError, match="do not match"):
    t_k7.flash_attention(tq, tk[:, :, :50], tv, 0.25)


def _forward_models(attn_block):
  jcfg = dataclasses.replace(j_get_arch(ARCH, reduced=True),
                             attn_block=attn_block, cache_policy="exact")
  tcfg = dataclasses.replace(t_get_arch(ARCH, reduced=True),
                             attn_block=attn_block, cache_policy="exact",
                             decode_kernel="torch")
  jm = JModel(jcfg, context_len=128)
  params = jm.init(jax.random.PRNGKey(0))
  tm = TModel(tcfg, context_len=128, device="cpu")
  params_from_numpy(tm, jax.tree_util.tree_map(np.asarray, params))
  return jm, params, tm


@pytest.mark.parametrize("s,attn_block", [
    (48, 64),     # one block: the reference's flash route
    (128, 64),    # two whole blocks: the reference's flash route
    (80, 64),     # 80 % 64 != 0: the reference's chunked route
])
def test_model_forward_matches_reference(s, attn_block):
  jm, params, tm = _forward_models(attn_block)
  toks = np.random.default_rng(s).integers(0, 256, size=(2, s)).astype(
      np.int32)
  j_logits, j_aux = jm.forward(params, jnp.asarray(toks))
  t_logits, t_aux = tm.forward(torch.from_numpy(toks))
  assert tuple(t_logits.shape) == (2, s, 256)
  np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                             rtol=1e-4, atol=1e-4)
  assert float(t_aux) == float(j_aux) == 0.0
  # the prefill's last-token logits are the forward's at the last position
  p_logits, _ = tm.prefill(torch.from_numpy(toks))
  np.testing.assert_allclose(p_logits.numpy(), t_logits[:, -1].numpy(),
                             rtol=1e-5, atol=1e-5)


def test_model_forward_cuda_routing_matches_torch():
  _, _, tm = _forward_models(64)
  toks = torch.from_numpy(np.random.default_rng(1).integers(
      0, 256, size=(2, 128)))
  want, _ = tm.forward(toks)
  # the cuda routing sends the attention to K7's wrapper, which takes its
  # plain version on CPU tensors (one block of 128 in place of two of 64)
  tm.cache_policy.dispatch = decode_dispatch.DecodeDispatch("cuda", True)
  before = t_k7.flash_attention.launches
  got, _ = tm.forward(toks)
  np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                             atol=1e-5)
  assert t_k7.flash_attention.launches == before


@pytest.mark.parametrize("s", [48, 80, 128, 100])
def test_cuda_routing_sends_every_length_to_k7(s, monkeypatch):
  """K7 masks a ragged last tile itself, so under `cuda` no length falls
  back to the plain attention on the card (80 and 100 are not multiples of
  the 64-token block); under `torch` the wrapper is never called."""
  _, _, tm = _forward_models(64)
  calls = []
  real = t_ops.flash_attention

  def spy(q, k, v, scale, causal=True):
    calls.append(q.shape[2])
    return real(q, k, v, scale, causal)

  monkeypatch.setattr(t_ops, "flash_attention", spy)
  toks = torch.from_numpy(np.random.default_rng(s).integers(
      0, 256, size=(1, s)))
  tm.forward(toks)
  tm.prefill(toks)
  assert calls == []
  tm.cache_policy.dispatch = decode_dispatch.DecodeDispatch("cuda", True)
  tm.forward(toks)
  tm.prefill(toks)
  assert calls == [s] * (2 * tm.cfg.n_layers)


@pytest.mark.parametrize("n,causal", [(40, True), (64, False), (1, True)])
def test_kernel_error_bound_covers_bf16_p(n, causal):
  """The bound K7 is held to on the card covers what its bf16 arithmetic
  does: P = exp(s - max) rounded to bf16 for the PV product, the
  denominator summed from f32 P, the output rounded to bf16.  Emulated here
  on one tile of keys; f32 inputs get 1e-5."""
  rng = np.random.default_rng(n)
  q, k, v = (torch.from_numpy(rng.standard_normal((2, 4, n, 32)).astype(
      np.float32) * sd).to(torch.bfloat16)
             for sd in (1.0, 1.0, 2.0))
  k2, v2 = k[:, ::2], v[:, ::2]          # GQA: Hq 4 over Hkv 2
  kg, vg = k2[:, [0, 0, 1, 1]].float(), v2[:, [0, 0, 1, 1]].float()
  s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kg) * 0.2
  if causal:
    s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1), -torch.inf)
  p = torch.exp(s - s.amax(-1, keepdim=True))
  emulated = (torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), vg)
              / p.sum(-1, keepdim=True)).bfloat16()
  plain = t_k7.flash_attention_plain(q, k2, v2, 0.2, causal)
  bound = t_k7.kernel_error_bound(q, k2, v2, 0.2, causal, plain)
  diff = (emulated.float() - plain.float()).abs()
  assert bool((diff <= bound).all())
  # the bound is not slack where P's rounding matters: without its 2^-8
  # term some element of a many-key row escapes (n = 1 has P = 1 exactly)
  if n > 1:
    assert bool((diff > 2.0 ** -7 * plain.float().abs() + 1e-5).any())
  f32 = t_k7.kernel_error_bound(q.float(), k2.float(), v2.float(), 0.2,
                                causal, plain.float())
  assert bool((f32 == t_k7.F32_ATOL).all())
