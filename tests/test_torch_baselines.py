"""The four baseline policies of the paper's Fig. 10 (`streamingllm`,
`skvq`, `snapkv`, `pqcache`) in the port, against the reference.

  - each function of `core/baselines.py` against `repro.core.baselines`,
    per (batch, kv head) row (the port batches what the reference vmaps):
    channel orders, codes, masks and selections exactly; floats within 1e-5
    (f32 on the CPU, sums in another order); `pqcache` on random normal
    keys, where the k-means meets no distance tie (ROADMAP C6);
  - `bytes()` of all six policies equal to the reference's dicts;
  - policy-level `append_and_attend` over 4 decode steps on ragged
    lengths (outputs within 1e-5; stores, snapkv's tracked weights with +inf
    for generated tokens included, equal);
  - engine traces on the reduced model, tokens and block counts equal to
    the reference engine's: `streamingllm` on the paged layout with a
    16-token window over blocks of 8, so blocks age out and are freed;
    `snapkv` paged (dense gather program with its weight pool); `skvq` and
    `pqcache` contiguous;
  - the serve CLI on the CPU for each baseline.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import baselines as j_bl
from repro.core import cache_api as j_api
from repro.core import cache_registry as j_reg
from repro.core import pq as j_pq
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.core import baselines as t_bl
from repro_torch.core import cache_api as t_api
from repro_torch.core import cache_registry as t_reg
from repro_torch.core import pq as t_pq
from repro_torch.launch import serve
from torch_parity import ARCH, engine_pair, random_trace

BASELINES = ("streamingllm", "skvq", "snapkv", "pqcache")
ATOL = RTOL = 1e-5
B, H, G, N, D = 2, 2, 2, 40, 16


def _rows(b, h):
  return [(i, j) for i in range(b) for j in range(h)]


def _data(seed, *shape):
  return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _lengths(seed, shape, lo, hi):
  return np.random.default_rng(seed).integers(lo, hi + 1, size=shape)


@pytest.mark.parametrize("bits,group", [(2, 8), (4, 8), (8, 16), (4, 32)])
def test_uniform_quantize_roundtrip_matches_reference(bits, group):
  x = _data(bits + group, B, H, N, 32)
  xt = torch.from_numpy(x)
  perm = t_bl.channel_reorder_by_range(xt)
  uq = t_bl.uniform_quantize(xt, bits, group, perm)
  deq = t_bl.uniform_dequantize(uq, group)
  for i, j in _rows(B, H):
    jperm = j_bl.channel_reorder_by_range(jnp.asarray(x[i, j]))
    np.testing.assert_array_equal(perm[i, j].numpy(), np.asarray(jperm))
    juq = j_bl.uniform_quantize(jnp.asarray(x[i, j]), bits, group, jperm)
    np.testing.assert_array_equal(uq.q[i, j].numpy(), np.asarray(juq.q))
    np.testing.assert_allclose(uq.scale[i, j].numpy(), np.asarray(juq.scale),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(uq.zero[i, j].numpy(), np.asarray(juq.zero),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        deq[i, j].numpy(), np.asarray(j_bl.uniform_dequantize(juq, group)),
        rtol=RTOL, atol=ATOL)


def _attn_inputs(seed):
  q, k, v = _data(seed, B, H, G, D), _data(seed + 1, B, H, N, D), \
      _data(seed + 2, B, H, N, D)
  return q, k, v, _lengths(seed, (B, H), 1, N)


def test_skvq_decode_attention_matches_reference():
  q, k, v, ln = _attn_inputs(1)
  mask = np.arange(N)[None, None] < ln[..., None]
  got = t_bl.skvq_decode_attention(*map(torch.from_numpy, (q, k, v, mask)),
                                   0.25, bits=4, group=8)
  for i, j in _rows(B, H):
    want = j_bl.skvq_decode_attention(q[i, j], k[i, j], v[i, j],
                                      jnp.asarray(mask[i, j]), 0.25, bits=4,
                                      group=8)
    np.testing.assert_allclose(got[i, j].numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("keep", [1, 5, 30])
def test_snapkv_select_and_attention_match_reference(keep):
  q, k, v, ln = _attn_inputs(2)
  w = np.abs(_data(3, B, H, N))
  w[0, 0, 20:24] = np.inf                     # generated tokens
  w[1, 1, 5:9] = w[1, 1, 12]                  # equal weights: ties
  mask = t_bl.snapkv_select(torch.from_numpy(w), keep, 4, 8,
                            torch.from_numpy(ln))
  got = t_bl.snapkv_decode_attention(
      *map(torch.from_numpy, (q, k, v, w)), torch.from_numpy(ln), 0.25, keep,
      sink=4, recent=8)
  for i, j in _rows(B, H):
    jmask = j_bl.snapkv_select(jnp.asarray(w[i, j]), keep, 4, 8,
                               int(ln[i, j]))
    np.testing.assert_array_equal(mask[i, j].numpy(), np.asarray(jmask))
    want = j_bl.snapkv_decode_attention(q[i, j], k[i, j], v[i, j], w[i, j],
                                        int(ln[i, j]), 0.25, keep, sink=4,
                                        recent=8)
    np.testing.assert_allclose(got[i, j].numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sink,window", [(4, 16), (0, 8), (8, 64)])
def test_streaming_llm_decode_attention_matches_reference(sink, window):
  q, k, v, ln = _attn_inputs(4)
  got = t_bl.streaming_llm_decode_attention(
      *map(torch.from_numpy, (q, k, v, ln)), 0.3, sink=sink, window=window)
  for i, j in _rows(B, H):
    want = j_bl.streaming_llm_decode_attention(
        q[i, j], k[i, j], v[i, j], int(ln[i, j]), 0.3, sink=sink,
        window=window)
    np.testing.assert_allclose(got[i, j].numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("keep", [6, N])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_pqcache_decode_attention_matches_reference(keep, use_kernel):
  q, k, v, ln = _attn_inputs(5)
  mask = np.arange(N)[None, None] < ln[..., None]
  cfg_j, cfg_t = j_pq.PQConfig(m=4, k=16, iters=4), \
      t_pq.PQConfig(m=4, k=16, iters=4)
  # with use_kernel every assignment goes through K6's wrapper, which takes
  # its plain version on CPU tensors
  got, traffic = t_bl.pqcache_decode_attention(
      *map(torch.from_numpy, (q, k, v, mask)), 0.25, cfg_t, keep,
      use_kernel=use_kernel)
  for i, j in _rows(B, H):
    want, j_traffic = j_bl.pqcache_decode_attention(
        q[i, j], k[i, j], v[i, j], jnp.asarray(mask[i, j]), 0.25, cfg_j,
        keep)
    np.testing.assert_allclose(got[i, j].numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    assert traffic == j_traffic


@pytest.mark.parametrize("arch_reduced,context", [(True, 64), (True, 112),
                                                  (False, 1056)])
@pytest.mark.parametrize("policy", ("exact", "pq") + BASELINES)
def test_policy_bytes_match_reference(policy, arch_reduced, context):
  jcfg = dataclasses.replace(j_get_arch(ARCH, reduced=arch_reduced),
                             cache_policy=policy)
  tcfg = dataclasses.replace(t_get_arch(ARCH, reduced=arch_reduced),
                             cache_policy=policy)
  jp, tp = jcfg.make_cache_policy(context), tcfg.make_cache_policy(context)
  assert tp.spec.window == jp.spec.window == min(512, context)
  for b, h in ((1, 2), (4, 4)):
    assert tp.bytes(b, h, tcfg.head_dim) == jp.bytes(b, h, jcfg.head_dim)
  assert tuple(tp.spill_codecs()) == tuple(jp.spill_codecs())
  assert tp.needs_weights == jp.needs_weights


def _policy_pair(name):
  kw = dict(capacity=64, head_dim=D, sink=4, recent=8, window=24)
  jp = j_reg.make(name, j_api.CacheSpec(dtype=jnp.float32,
                                        decode_kernel="xla", **kw))
  tp = t_reg.make(name, t_api.CacheSpec(dtype=torch.float32,
                                        decode_kernel="torch", **kw))
  return jp, tp


def _assert_state(t_state, j_state):
  assert type(t_state).__name__ == type(j_state).__name__
  for f in j_state._fields:
    np.testing.assert_array_equal(getattr(t_state, f).numpy(),
                                  np.asarray(getattr(j_state, f)))


@pytest.mark.parametrize("name", BASELINES)
def test_policy_decode_steps_match_reference(name):
  jp, tp = _policy_pair(name)
  hq = H * G
  k, v = _data(6, B, H, N, D), _data(7, B, H, N, D)
  w = np.abs(_data(8, B, H, N))
  lengths = np.array([N, 29], np.int32)          # a right-padded second row
  j_state = jp.prefill(jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(w) if jp.needs_weights else None,
                       jnp.asarray(lengths))
  t_state = tp.prefill(torch.from_numpy(k), torch.from_numpy(v),
                       torch.from_numpy(w) if tp.needs_weights else None,
                       torch.from_numpy(lengths))
  _assert_state(t_state, j_state)
  for step in range(4):
    q = _data(20 + step, B, hq, D)
    kn, vn = _data(30 + step, B, H, D), _data(40 + step, B, H, D)
    ln = lengths + step
    j_out, j_state = jp.append_and_attend(j_state, jnp.asarray(q),
                                          jnp.asarray(kn), jnp.asarray(vn),
                                          jnp.asarray(ln))
    t_out, t_state = tp.append_and_attend(t_state, torch.from_numpy(q),
                                          torch.from_numpy(kn),
                                          torch.from_numpy(vn),
                                          torch.from_numpy(ln))
    assert tuple(t_out.shape) == (B, hq, D)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=RTOL,
                               atol=ATOL)
    _assert_state(t_state, j_state)
  if name == "snapkv":
    assert np.isinf(t_state.w.numpy()[0, :, N:N + 4]).all()


FIELDS = ("tokens", "admitted_step", "finished_step", "slot", "preempt_count")


@pytest.mark.parametrize("policy,layout,sched,trace", [
    ("streamingllm", "paged", "paged", random_trace(3)),
    ("snapkv", "paged", "fifo", random_trace(4, n=4)),
    ("skvq", "contiguous", "fifo", random_trace(5, n=3)),
    ("pqcache", "contiguous", "fifo", random_trace(6, n=3)),
])
def test_engine_trace_matches_reference(policy, layout, sched, trace):
  kw = dict(stream_window=16, kv_block_size=8) if policy == "streamingllm" \
      else {}
  je, te = engine_pair(policy, layout, sched, **kw)
  handles = [(je.submit(p, mx), te.submit(p, mx)) for p, mx in trace]
  j_done = je.run_to_completion()
  t_done = te.run_to_completion()
  assert [r.rid for r in t_done] == [r.rid for r in j_done]
  for jh, th in handles:
    for f in FIELDS:
      assert getattr(th, f) == getattr(jh, f), (th.rid, f)
  for f in ("admits", "preempts", "decode_steps", "blocks_reclaimed"):
    assert getattr(te.stats, f) == getattr(je.stats, f), f
  if layout == "paged":
    t_by, j_by = te.layout.bytes(), je.layout.bytes()
    for f in ("peak_blocks", "block_bytes", "num_blocks", "allocated_blocks"):
      assert t_by[f] == j_by[f], f
    te.layout.manager.check_invariants()
    assert te.layout.free_blocks == te.layout.num_blocks
  if policy == "streamingllm":
    # a 16-token window over 8-token blocks: the requests' old blocks died
    assert te.stats.blocks_reclaimed > 0
    assert te.layout.block == 8 and te.model.cache_policy.spec.window == 16


@pytest.mark.parametrize("policy", BASELINES)
def test_cli_serves_each_baseline_on_cpu(policy, tmp_path, capsys):
  path = tmp_path / "stats.json"
  res = serve.main(["--arch", "tinyllama-1.1b", "--reduced", "--batch", "2",
                    "--prompt-len", "48", "--gen", "3", "--device", "cpu",
                    "--cache-policy", policy, "--stats-json", str(path)])
  assert f"policy={policy}" in capsys.readouterr().out
  stats = json.loads(path.read_text())
  assert stats["cache_policy"] == policy and stats["decode_kernel"] == "torch"
  toks = torch.tensor(stats["tokens"])
  assert toks.shape == (2, 3) and torch.equal(toks, res["tokens"])
