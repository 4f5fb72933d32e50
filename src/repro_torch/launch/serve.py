"""End-to-end serving driver: batched prefill -> cache policy -> decode loop
(port of `repro.launch.serve.ServeRun`, single device, contiguous layout).

  python -m repro_torch.launch.serve --arch tinyllama-1.1b --cache-policy pq \
      --batch 4 --prompt-len 1024 --gen 16

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

import torch

from repro_torch.common.timing import Stopwatch, latency_percentiles_ms
from repro_torch.common.types import resolve_device
from repro_torch.configs import get_arch
from repro_torch.models.model import Model


@dataclasses.dataclass
class ServeRun:
  arch: str
  reduced: bool = True
  batch: int = 4
  prompt_len: int = 128
  gen: int = 32
  cache_policy: str = "pq"
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
        "decode_kernel": model.cache_policy.effective_decode_kernel,
        "pq": policy_name == "pq",
        "device": (torch.cuda.get_device_name(model.device)
                   if model.device.type == "cuda" else "cpu"),
    }


def make_parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--arch", default="tinyllama-1.1b")
  ap.add_argument("--reduced", action="store_true",
                  help="the smoke-scale variant of the arch")
  ap.add_argument("--batch", type=int, default=4)
  ap.add_argument("--prompt-len", type=int, default=128)
  ap.add_argument("--gen", type=int, default=32)
  ap.add_argument("--cache-policy", choices=("exact", "pq"), default="pq")
  ap.add_argument("--decode-kernel", choices=("auto", "cuda", "torch"),
                  default="auto")
  ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--stats-json", default=None, metavar="PATH",
                  help="write the run's stats (tokens included) as JSON")
  return ap


def main(argv=None):
  args = make_parser().parse_args(argv)
  run = ServeRun(arch=args.arch, reduced=args.reduced, batch=args.batch,
                 prompt_len=args.prompt_len, gen=args.gen,
                 cache_policy=args.cache_policy,
                 decode_kernel=args.decode_kernel, device=args.device,
                 seed=args.seed)
  res = run.run()
  print(f"arch={args.arch} policy={res['cache_policy']} "
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
