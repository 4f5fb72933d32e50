"""The port's `ServeEngine` against the reference's, on the same submit
traces (reduced tinyllama in f32, params shared through numpy).

For every request: tokens, `admitted_step`, `finished_step`, `slot` and
`preempt_count` exactly equal, over the `contiguous` and `paged` layouts,
the `fifo`, `sjf` and `paged` schedulers, the `exact` and `pq` policies, and
two traces whose small pools force recompute preemption.  The reference
engine runs without a mesh (its `ServeRun` is red on this JAX version,
ROADMAP C1); on the CPU both decode with the plain path (the reference's
`xla`, the port's `torch`).
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.configs import get_arch as t_get_arch
from repro_torch.core import cache_registry
from repro_torch.launch import scheduler as t_scheduler
from repro_torch.launch.engine import ServeEngine as TEngine
from torch_parity import ARCH, engine_pair, random_trace

def block_edge_trace(prompt_len):
  """Three prompts whose paged tokens fill whole 16-token blocks, so every
  request needs one more block at its first decode step: exact pages the
  whole prompt (48 = 3 blocks), pq its body (44 - sink 4 - recent 8 = 32 =
  2 blocks).  Admission keeps one block of headroom per request, so a pool
  of 3 * blocks + 1 admits all three and runs dry at the first step."""
  rng = np.random.default_rng(9)
  return [(rng.integers(0, 256, size=prompt_len), 10) for _ in range(3)]


FIELDS = ("tokens", "admitted_step", "finished_step", "slot", "preempt_count")


@pytest.mark.parametrize("policy,layout,sched,num_blocks,trace", [
    ("exact", "contiguous", "fifo", None, random_trace(1)),
    ("pq", "contiguous", "sjf", None, random_trace(1)),
    ("pq", "paged", "paged", None, random_trace(1)),
    ("exact", "paged", "sjf", None, random_trace(2)),
    ("exact", "paged", "paged", 10, block_edge_trace(48)),
    ("pq", "paged", "paged", 7, block_edge_trace(44)),
], ids=["exact-contiguous-fifo", "pq-contiguous-sjf", "pq-paged-paged",
        "exact-paged-sjf", "exact-paged-preempt", "pq-paged-preempt"])
def test_engine_matches_reference(policy, layout, sched, num_blocks, trace):
  je, te = engine_pair(policy, layout, sched, num_blocks)
  handles = [(je.submit(p, mx), te.submit(p, mx)) for p, mx in trace]
  j_done = je.run_to_completion()
  t_done = te.run_to_completion()
  assert [r.rid for r in t_done] == [r.rid for r in j_done]
  for jh, th in handles:
    for f in FIELDS:
      assert getattr(th, f) == getattr(jh, f), (th.rid, f)
    assert th.done and len(th.tokens) == th.max_new_tokens
  assert te.stats.preempts == je.stats.preempts
  assert te.stats.admits == je.stats.admits
  assert te.stats.decode_steps == je.stats.decode_steps
  if num_blocks is not None:
    assert te.stats.preempts >= 1
  if layout == "paged":
    te.layout.manager.check_invariants()
    assert te.layout.free_blocks == te.layout.num_blocks


def test_unported_keys_and_arguments_raise_naming_roadmap():
  assert t_scheduler.names() == ("fifo", "paged", "sjf")
  assert cache_registry.layout_names() == ("contiguous", "paged")
  for name, item in (("tiered", "A9"), ("prefix", "A10"), ("slo", "A11")):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
      t_scheduler.make(name)
  with pytest.raises(NotImplementedError, match="ROADMAP A9"):
    cache_registry.get_layout("tiered")
  cfg = t_get_arch(ARCH, reduced=True)
  for kw, item in ((dict(prefix_cache=True), "A10"),
                   (dict(slo_enforce=True), "A11"),
                   (dict(mesh_model=2), "A13")):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
      TEngine(cfg, context_len=96, max_batch=2, device="cpu", **kw)
  with pytest.raises(ValueError, match="requires cache_layout='paged'"):
    TEngine(cfg, context_len=96, max_batch=2, device="cpu",
            scheduler="paged")


def test_engine_serves_a_built_model():
  cfg = dataclasses.replace(t_get_arch(ARCH, reduced=True),
                            cache_layout="paged", scheduler="paged")
  first = TEngine(cfg, context_len=96, max_batch=2, device="cpu", seed=3)
  again = TEngine(cfg, context_len=96, max_batch=2, model=first.model)
  assert again.model is first.model and again.layout is not first.layout
  prompt = np.arange(1, 41)
  a, b = first.submit(prompt, 4), again.submit(prompt, 4)
  first.run_to_completion()
  again.run_to_completion()
  assert a.tokens == b.tokens and len(a.tokens) == 4
  with pytest.raises(ValueError, match="context"):
    TEngine(cfg, context_len=112, max_batch=2, model=first.model)


# ---------------------------------------------------------------------------
# Config fields the reference reads on the serve path (ROADMAP C8): each is
# either read as the reference reads it or refused naming its ROADMAP item.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field,value", [("prefix_cache", True),
                                         ("prefix_cache_blocks", 8)])
def test_config_prefix_cache_is_refused_naming_a10(field, value):
  cfg = dataclasses.replace(t_get_arch(ARCH, reduced=True),
                            cache_layout="paged", **{field: value})
  with pytest.raises(NotImplementedError, match="ROADMAP A10"):
    TEngine(cfg, context_len=96, max_batch=2, device="cpu")


def test_config_spill_codec_is_validated_as_the_reference():
  from repro.configs import get_arch as j_get_arch
  base = t_get_arch(ARCH, reduced=True)
  msg = r"spill_codec must be one of \('int8', 'q4', 'q5', 'q8', 'raw'\)"
  with pytest.raises(ValueError, match=msg):
    dataclasses.replace(j_get_arch(ARCH, reduced=True),
                        spill_codec="gzip").make_cache_policy(64)
  with pytest.raises(ValueError, match=msg):
    dataclasses.replace(base, spill_codec="gzip").make_cache_policy(64)
  with pytest.raises(ValueError, match=msg):
    TEngine(dataclasses.replace(base, spill_codec="gzip"), context_len=96,
            max_batch=2, device="cpu")
  for codec in ("raw", "int8", "q4", "q5", "q8"):
    policy = dataclasses.replace(base, cache_policy="exact",
                                 spill_codec=codec).make_cache_policy(64)
    assert tuple(policy.spill_codecs()) == (codec, codec)


def test_config_stream_window_reaches_the_policy():
  base = dataclasses.replace(t_get_arch(ARCH, reduced=True),
                             cache_policy="streamingllm")
  assert base.make_cache_policy(96).spec.window == 96       # clamped
  cfg = dataclasses.replace(base, stream_window=16)
  assert cfg.make_cache_policy(96).spec.window == 16
  assert cfg.make_cache_policy(96).dead_below(40) == 24


def test_config_host_blocks_is_ignored_outside_tiered_as_the_reference():
  # the reference hands cfg.host_blocks to the layout, and only the tiered
  # layout (ROADMAP A9) reads it: paged serving is the same with it set
  trace = random_trace(7, n=3)
  runs = []
  for host_blocks in (None, 8):
    je, te = engine_pair("exact", "paged", "paged", host_blocks=host_blocks)
    handles = [(je.submit(p, mx), te.submit(p, mx)) for p, mx in trace]
    je.run_to_completion()
    te.run_to_completion()
    for jh, th in handles:
      assert th.tokens == jh.tokens
    runs.append([th.tokens for _, th in handles])
  assert runs[0] == runs[1]
