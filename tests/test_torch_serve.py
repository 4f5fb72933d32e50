"""The port's serve entry point, device rules, dispatch and import rule."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.core import cache_api, cache_registry, decode_dispatch
from repro_torch.launch import serve

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARGS = ["--arch", "tinyllama-1.1b", "--reduced", "--batch", "2",
        "--prompt-len", "48", "--gen", "4"]
STATS_KEYS = {"tokens", "prefill_s", "decode_s", "tok_per_s",
              "decode_step_p50_ms", "decode_step_p99_ms", "cache_policy",
              "decode_kernel", "pq"}


@pytest.mark.parametrize("policy", ["pq", "exact"])
def test_cli_on_cpu_prints_tokens_and_writes_stats(policy, tmp_path, capsys):
  path = tmp_path / "stats.json"
  res = serve.main(ARGS + ["--device", "cpu", "--cache-policy", policy,
                           "--stats-json", str(path)])
  out = capsys.readouterr().out
  assert "sample tokens:" in out and f"policy={policy}" in out
  stats = json.loads(path.read_text())
  assert STATS_KEYS <= set(stats)
  assert stats["cache_policy"] == policy and stats["pq"] == (policy == "pq")
  assert stats["decode_kernel"] == "torch" and stats["device"] == "cpu"
  toks = torch.tensor(stats["tokens"])
  assert toks.shape == (2, 4) and toks.min() >= 0 and toks.max() < 256
  assert torch.equal(toks, res["tokens"])


def test_cli_without_device_flag_needs_a_card():
  if torch.cuda.is_available():
    pytest.skip("a card is present: the default device is valid here")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    serve.main(ARGS)


ENGINE_ARGS = ["--arch", "tinyllama-1.1b", "--reduced", "--engine",
               "--cache-layout", "paged", "--scheduler", "paged",
               "--prompt-len", "64", "--gen", "8", "--batch", "2"]


def test_engine_cli_on_cpu_prints_requests_and_writes_stats(tmp_path,
                                                            capsys):
  path = tmp_path / "engine.json"
  res = serve.main(ENGINE_ARGS + ["--device", "cpu", "--stats-json",
                                  str(path)])
  out = capsys.readouterr().out
  stats = json.loads(path.read_text())
  assert stats["layout"] == "paged" and stats["scheduler"] == "paged"
  assert stats["decode_kernel"] == "torch" and stats["device"] == "cpu"
  assert stats["decode_path"] == "dense-gather"
  assert stats["finished"] == 4 and stats["preempts"] == 0
  assert stats["layout_bytes"]["kind"] == "paged"
  assert stats["decode_traffic"]["dense_materialized_bytes_per_step"] > 0
  assert [r["prompt_len"] for r in stats["requests"]] == [64, 47, 30, 13]
  for r in stats["requests"]:
    assert len(r["tokens"]) == 4 and f"request {r['rid']}: " in out
    assert all(0 <= t < 256 for t in r["tokens"])
  assert stats["requests"] == res["requests"]


@pytest.mark.parametrize("mode", ["serve-run", "engine"])
def test_cli_kv_resident_codec_serves_the_packed_store(mode, tmp_path):
  """`--kv-resident-codec q4` reaches the policy in both modes: the exact
  policy serves its packed store and the stats report it."""
  base = ARGS if mode == "serve-run" else ENGINE_ARGS
  stats = {}
  for codec in ("none", "q4"):
    path = tmp_path / f"{codec}.json"
    serve.main(base + ["--device", "cpu", "--cache-policy", "exact",
                       "--kv-resident-codec", codec, "--stats-json",
                       str(path)])
    stats[codec] = json.loads(path.read_text())
  if mode == "serve-run":
    assert stats["q4"]["kv_resident_codec"] == "q4"
    assert len(stats["q4"]["tokens"][0]) == 4
  else:
    by = {c: st["kv_bytes"] for c, st in stats.items()}
    assert by["q4"]["kv_resident_codec"] == "q4"
    # reduced tinyllama, d = 16: 8 code bytes + 4 header bytes per row
    # against 64 f32 bytes, for K and V
    assert by["q4"]["block_bytes"] * 64 == by["none"]["block_bytes"] * 12
    assert stats["q4"]["finished"] == 4


def test_engine_cli_without_device_flag_needs_a_card():
  if torch.cuda.is_available():
    pytest.skip("a card is present: the default device is valid here")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    serve.main(ENGINE_ARGS)


def test_serve_run_is_deterministic_per_seed():
  run = serve.ServeRun(arch="tinyllama-1.1b", reduced=True, batch=2,
                       prompt_len=48, gen=4, device="cpu",
                       measure_latency=False, warmup=False, seed=3)
  assert torch.equal(run.run()["tokens"], run.run()["tokens"])


def test_dispatch_resolves_by_device():
  assert decode_dispatch.names() == ("auto", "cuda", "torch")
  assert decode_dispatch.resolve("auto", "cpu").use_kernel is False
  assert decode_dispatch.resolve("torch", "cpu").key == "torch"
  with pytest.raises(ValueError, match="CUDA device"):
    decode_dispatch.resolve("cuda", "cpu")
  with pytest.raises(ValueError, match="unknown decode kernel"):
    decode_dispatch.validate("pallas")
  spec = cache_api.CacheSpec(capacity=64, head_dim=16, window=64,
                             decode_kernel="cuda")
  with pytest.raises(ValueError):            # resolved once, at build time
    cache_registry.make("exact", spec)


def test_unported_policies_raise_naming_roadmap():
  # every policy of the reference is ported (ROADMAP A8 was the last); what
  # is still unported is the tiered layout, and unknown keys stay unknown
  assert cache_registry.names() == ("exact", "pq", "pqcache", "skvq",
                                    "snapkv", "streamingllm")
  spec = cache_api.CacheSpec(capacity=64, head_dim=16, window=64)
  for name in cache_registry.names():
    if name != "pq":                       # pq needs its geometry
      assert cache_registry.make(name, spec).name == name
  with pytest.raises(KeyError, match="unknown cache policy"):
    cache_registry.make("h2o", spec)
  with pytest.raises(NotImplementedError, match="ROADMAP A9"):
    cache_registry.get_layout("tiered")


_IMPORT_CHECK = r"""
import importlib, pkgutil, sys
sys.path[:0] = [{root!r}, {src!r}]
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
  importlib.import_module(mod.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok", len([m for m in sys.modules if m.startswith("repro_torch")]))
"""


def test_port_imports_neither_jax_nor_reference():
  code = _IMPORT_CHECK.format(root=os.path.abspath(ROOT),
                              src=os.path.abspath(os.path.join(ROOT, "src")))
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
  assert out.returncode == 0, out.stderr
  assert out.stdout.startswith("ok ")
