"""End-to-end serving entry point (port of `repro.launch.serve`, single device).

Fixed batch (`ServeRun`): batched prefill -> cache policy -> decode loop.

  python -m repro_torch.launch.serve --arch tinyllama-1.1b --cache-policy pq \
      --batch 4 --prompt-len 1024 --gen 16

Continuous batching (`--engine`, `launch/engine.py`): a warm-up request,
then `batch + 2` requests of mixed prompt lengths through the engine's
layout and scheduler.

  python -m repro_torch.launch.serve --arch tinyllama-1.1b --engine \
      --cache-layout paged --scheduler paged --cache-policy pq \
      --batch 4 --prompt-len 1024 --gen 32

`--kv-resident-codec q4` (or q5, q8) makes the exact policy store its KV as
packed codes plus f16 headers, in both modes.  `--cache-policy` takes every
registered policy: `exact`, `pq`, and the baselines `streamingllm`, `skvq`,
`snapkv`, `pqcache`.

Runs on the card unless `--device cpu` is given; without a card and without
that flag it raises.  Weights and prompts are random, made from `--seed`.
With `pq` this runs the AQPIM path: prefill builds the compressed cache
(importance-weighted clustering), decode attends on the codes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.common.timing import Stopwatch, latency_percentiles_ms
from repro_torch.common.types import resolve_device
from repro_torch.configs import get_arch
from repro_torch.core import cache_registry
from repro_torch.kernels import packing
from repro_torch.models.model import Model


@dataclasses.dataclass
class ServeRun:
  arch: str
  reduced: bool = True
  batch: int = 4
  prompt_len: int = 128
  gen: int = 32
  cache_policy: str = "pq"
  kv_resident_codec: str = "none"  # exact-policy resident store (packing)
  decode_kernel: str = "auto"      # core/decode_dispatch key
  device: str = "cuda"
  measure_latency: bool = True     # the extra synced decode pass for p50/p99
  warmup: bool = True              # build kernels and caches outside the timing
  seed: int = 0

  def build(self) -> Model:
    """The model this run serves, with random weights from `seed`."""
    dev = resolve_device(self.device)
    cfg = get_arch(self.arch, reduced=self.reduced)
    cfg = dataclasses.replace(cfg, cache_policy=self.cache_policy,
                              kv_resident_codec=self.kv_resident_codec,
                              decode_kernel=self.decode_kernel)
    model = Model(cfg, context_len=self.prompt_len + self.gen, device=dev)
    return model.init(torch.Generator(device=dev).manual_seed(self.seed))

  def prompts(self, vocab_size: int) -> torch.Tensor:
    """Seeded prompts, drawn on the CPU so every device sees the same ones."""
    gen = torch.Generator().manual_seed(self.seed)
    return torch.randint(0, vocab_size, (self.batch, self.prompt_len),
                         generator=gen)

  def run(self, model: Model = None) -> dict:
    if model is None:
      model = self.build()
    cfg = model.cfg
    prompts = self.prompts(cfg.vocab_size).to(model.device)

    def lengths(i):
      return torch.full((self.batch,), self.prompt_len + i, dtype=torch.int32,
                        device=model.device)

    if self.warmup:
      logits_w, cache_w = model.prefill(prompts)
      model.decode_step(torch.argmax(logits_w, -1), cache_w, lengths(0))
      del logits_w, cache_w

    with Stopwatch() as sw_prefill:
      logits, cache = model.prefill(prompts)
      sw_prefill.wait_for(logits)

    tokens = [torch.argmax(logits, -1)]
    with Stopwatch() as sw_decode:
      for i in range(self.gen):
        logits, cache = model.decode_step(tokens[-1], cache, lengths(i))
        tokens.append(torch.argmax(logits, -1))
      sw_decode.wait_for(tokens[-1])
    del cache

    # per-step latency: a second pass that synchronises after every step,
    # so the throughput loop above keeps its asynchronous launches
    step_s = []
    if self.measure_latency:
      logits_l, cache_l = model.prefill(prompts)
      tok_l = torch.argmax(logits_l, -1)
      for i in range(self.gen):
        t0 = time.perf_counter()
        logits_l, cache_l = model.decode_step(tok_l, cache_l, lengths(i))
        tok_l = torch.argmax(logits_l, -1)
        if tok_l.device.type == "cuda":
          torch.cuda.synchronize(tok_l.device)
        step_s.append(time.perf_counter() - t0)

    lat = latency_percentiles_ms(step_s)
    out = torch.stack(tokens[:-1], dim=1).cpu()
    policy_name = cfg.resolved_cache_policy()
    return {
        "tokens": out,
        "prefill_s": sw_prefill.seconds,
        "decode_s": sw_decode.seconds,
        "tok_per_s": self.batch * self.gen / max(sw_decode.seconds, 1e-9),
        "decode_step_p50_ms": lat["p50_ms"],
        "decode_step_p99_ms": lat["p99_ms"],
        "cache_policy": policy_name,
        "kv_resident_codec": cfg.kv_resident_codec,
        "decode_kernel": model.cache_policy.effective_decode_kernel,
        "pq": policy_name == "pq",
        "device": (torch.cuda.get_device_name(model.device)
                   if model.device.type == "cuda" else "cpu"),
    }


def build_engine(args):
  """The `ServeEngine` the CLI flags describe.  With the paged layout the
  context (prompt + gen) is rounded up to whole KV blocks, which every
  paged policy's capacity must be."""
  from repro_torch.launch.engine import ServeEngine
  cfg = get_arch(args.arch, reduced=args.reduced)
  cfg = dataclasses.replace(cfg, cache_policy=args.cache_policy,
                            cache_layout=args.cache_layout,
                            scheduler=args.scheduler,
                            kv_block_size=args.block_size,
                            kv_resident_codec=args.kv_resident_codec,
                            decode_kernel=args.decode_kernel)
  context = args.prompt_len + args.gen
  if args.cache_layout == "paged":
    context = -(-context // args.block_size) * args.block_size
  return ServeEngine(cfg, context_len=context, max_batch=args.batch,
                     prompt_capacity=args.prompt_len, seed=args.seed,
                     device=args.device, num_blocks=args.num_blocks)


def engine_stats(engine, done=()) -> dict:
  """Machine-readable engine record: EngineStats.as_dict() plus the layout,
  scheduler, decode path and kernel, the layout's true footprint, the
  modeled decode traffic, and each finished request's tokens."""
  payload = engine.stats.as_dict()
  payload["layout"] = engine.layout.name
  payload["scheduler"] = engine.scheduler.name
  payload["decode_kernel"] = engine.model.cache_policy.effective_decode_kernel
  payload["layout_bytes"] = engine.layout.bytes(
      active_slots=engine.active_count)
  payload["kv_bytes"] = engine.kv_bytes()
  payload["decode_path"] = "dense"
  if hasattr(engine.layout, "decode_traffic"):
    payload["decode_traffic"] = engine.layout.decode_traffic
    payload["decode_path"] = engine.layout.decode_traffic["decode_path"]
  payload["device"] = (torch.cuda.get_device_name(engine.model.device)
                       if engine.model.device.type == "cuda" else "cpu")
  payload["requests"] = [dict(rid=r.rid, prompt_len=r.prompt_len,
                              tokens=list(r.tokens),
                              admitted_step=r.admitted_step,
                              finished_step=r.finished_step,
                              preempt_count=r.preempt_count) for r in done]
  return payload


def run_engine_demo(args) -> dict:
  """Continuous batching: mixed prompt lengths, staggered finishes.  A
  warm-up request is drained first and the stats reset, so the latency
  percentiles are steady-state steps."""
  engine = build_engine(args)
  cfg = engine.cfg
  warm_len = min(8, args.prompt_len)
  engine.submit([1] * warm_len, max_new_tokens=2)
  engine.run_to_completion()
  warmup_steps = engine.stats.decode_steps
  engine.reset_stats()
  rng = np.random.default_rng(args.seed)
  floor = min(8, args.prompt_len)
  max_new = max(1, min(args.gen, max(2, args.gen // 2)))
  for i in range(args.batch + 2):
    ln = max(floor, args.prompt_len - 17 * i)
    engine.submit(rng.integers(0, cfg.vocab_size, size=ln),
                  max_new_tokens=max_new)
  with Stopwatch() as sw:
    done = engine.run_to_completion()
  n_tok = sum(len(r.tokens) for r in done)
  res = engine_stats(engine, done)
  res["warmup_decode_steps"] = warmup_steps
  res["wall_s"] = sw.seconds
  res["tok_per_s"] = n_tok / max(sw.seconds, 1e-9)
  print(f"engine: {len(done)} requests, {n_tok} tokens in {sw.seconds:.2f}s "
        f"({res['tok_per_s']:.1f} tok/s) [layout={res['layout']} "
        f"scheduler={res['scheduler']} kernel={res['decode_kernel']} "
        f"{res['decode_path']}] device={res['device']}")
  for r in sorted(done, key=lambda r: r.rid):
    print(f"  request {r.rid}: prompt {r.prompt_len}, admitted step "
          f"{r.admitted_step}, finished step {r.finished_step}, tokens "
          f"{r.tokens}")
  if "decode_traffic" in res:
    tm = res["decode_traffic"]
    print(f"decode traffic (peak/step): {tm['decode_path']}: dense "
          f"materialized {tm['dense_materialized_bytes_per_step']} B, "
          f"block reads {tm['block_read_bytes_per_step']} B, row writes "
          f"{tm['row_write_bytes_per_step']} B")
  print(f"engine stats: {engine.stats.summary()}")
  by = res["layout_bytes"]
  if by["kind"] == "paged":
    print(f"kv memory: peak {by['peak_blocks']}/{by['num_blocks']} blocks "
          f"x {by['block_bytes']} B (+{by['resident_bytes_per_slot']} B/slot "
          f"resident), pool capacity {by['capacity_bytes']} B")
  if args.stats_json:
    with open(args.stats_json, "w") as f:
      json.dump(res, f, indent=1)
    print(f"stats written to {args.stats_json}")
  return res


def make_parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--arch", default="tinyllama-1.1b")
  ap.add_argument("--reduced", action="store_true",
                  help="the smoke-scale variant of the arch")
  ap.add_argument("--batch", type=int, default=4)
  ap.add_argument("--prompt-len", type=int, default=128)
  ap.add_argument("--gen", type=int, default=32)
  ap.add_argument("--cache-policy", choices=cache_registry.names(),
                  default="pq")
  ap.add_argument("--kv-resident-codec", default="none",
                  choices=tuple(packing.RESIDENT_CODECS),
                  help="exact-policy resident KV store: none keeps dense "
                       "floats; q4/q5/q8 store packed codes + f16 headers "
                       "(kernels/packing.py), about 0.19x the fp32 "
                       "footprint at q4")
  ap.add_argument("--decode-kernel", choices=("auto", "cuda", "torch"),
                  default="auto")
  ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--stats-json", default=None, metavar="PATH",
                  help="write the run's stats (tokens included) as JSON")
  ap.add_argument("--engine", action="store_true",
                  help="run the continuous-batching ServeEngine demo")
  ap.add_argument("--cache-layout", choices=("contiguous", "paged"),
                  default="contiguous",
                  help="engine mode: physical KV storage, capacity-sized "
                       "slabs or a pool of token blocks")
  ap.add_argument("--scheduler", choices=("fifo", "sjf", "paged"),
                  default="fifo",
                  help="engine admission policy (paged requires "
                       "--cache-layout paged)")
  ap.add_argument("--block-size", "--kv-block-size", dest="block_size",
                  type=int, default=16,
                  help="paged-layout token-block granularity")
  ap.add_argument("--num-blocks", type=int, default=None,
                  help="paged-layout pool size (default: batch * "
                       "capacity/block, the contiguous equivalent)")
  return ap


def main(argv=None):
  args = make_parser().parse_args(argv)
  if args.engine:
    return run_engine_demo(args)
  run = ServeRun(arch=args.arch, reduced=args.reduced, batch=args.batch,
                 prompt_len=args.prompt_len, gen=args.gen,
                 cache_policy=args.cache_policy,
                 kv_resident_codec=args.kv_resident_codec,
                 decode_kernel=args.decode_kernel, device=args.device,
                 seed=args.seed)
  res = run.run()
  print(f"arch={args.arch} policy={res['cache_policy']} "
        f"codec={res['kv_resident_codec']} "
        f"kernel={res['decode_kernel']} device={res['device']} "
        f"prefill={res['prefill_s']:.2f}s decode={res['decode_s']:.2f}s "
        f"({res['tok_per_s']:.1f} tok/s, step p50 "
        f"{res['decode_step_p50_ms']:.2f} / p99 "
        f"{res['decode_step_p99_ms']:.2f} ms)")
  print("sample tokens:", res["tokens"][0, :16].tolist())
  if args.stats_json:
    stats = dict(res, tokens=res["tokens"].tolist())
    with open(args.stats_json, "w") as f:
      json.dump(stats, f, indent=1)
    print(f"stats written to {args.stats_json}")
  return res


if __name__ == "__main__":
  main()
