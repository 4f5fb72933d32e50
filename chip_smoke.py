"""On-card smoke test of the PyTorch + CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card (built for an H100, sm_90a) and the CUDA toolkit.  It

  1. builds the decode kernels from `src/repro_torch/csrc/` (one `nvcc` per
     source, all started together) into `build/repro_torch/`;
  2. holds each kernel against its plain PyTorch version on the card at the
     serve path's full-width shapes and times kernel, plain version, the
     bound and (where one exists) a single PyTorch library call;
  3. serves full-width tinyllama-1.1b (random bf16 weights from a seed)
     through `ServeRun` with the `pq` and the `exact` policy, batch 4,
     prompt 1024, 16 generated tokens, and checks from the launch counters
     that every layer of every decode step ran its kernel;
  4. from one prefilled cache per policy, runs 4 teacher-forced decode steps
     with the `cuda` and the `torch` dispatch and compares the logits;
  5. profiles 3 decode steps per policy (`torch.profiler`): device busy
     share and the kernels that take the device time.

Every check that fails raises, so the script exits non-zero.  The last line
is a JSON object naming the device; the line before it lists the kernels.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "tinyllama-1.1b"
BATCH, PROMPT, GEN = 4, 1024, 16
PARITY_STEPS = 4
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per s
# Kernel vs plain version, both f32 accumulation over the same bf16 inputs;
# only the order of the f32 sums differs.
KERNEL_ATOL = 1e-4
# Logits of the cuda vs torch dispatch: the models run in bf16, so an f32
# difference of 1e-6 in one attention output can flip a bf16 rounding (2^-8
# relative) that 22 layers carry to the logits.
LOGIT_ATOL = 0.25


def smi_line() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  t0 = torch.cuda.Event(enable_timing=True)
  t1 = torch.cuda.Event(enable_timing=True)
  t0.record()
  for _ in range(iters):
    fn()
  t1.record()
  torch.cuda.synchronize()
  return t0.elapsed_time(t1) / iters


def bound(nbytes: float, ops: float, dtype) -> tuple:
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = ops / PEAK_OPS[dtype] * 1e3
  return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(dev, tag) -> dict:
  """K1 and K2 against their plain versions at the serve path's shapes."""
  from repro_torch.kernels import paged_flash_decode as pfd
  from repro_torch.kernels import pq_decode as pqd

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  gen = torch.Generator(device=dev).manual_seed(0)
  b, h, g, d, m, k_cent, n = BATCH, 4, 8, 64, 32, 512, 1024
  bh, dsub, scale = b * h, d // m, d ** -0.5

  def randn(*shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)

  q = randn(bh, g, d)
  kcb, vcb = randn(bh, m, k_cent, dsub), randn(bh, m, k_cent, dsub)
  kidx = torch.randint(0, k_cent, (bh, n, m), generator=gen, device=dev,
                       dtype=torch.int16)
  vidx = torch.randint(0, k_cent, (bh, n, m), generator=gen, device=dev,
                       dtype=torch.int16)
  # the serve path's body length (prompt 1024 - sink 8 - recent 32) and a
  # ragged batch with empty, one-token and full rows
  full = torch.full((bh,), PROMPT - 40, dtype=torch.int32, device=dev)
  ragged = torch.tensor([0, 1, 63, 64, 65, 517, 1000, 1024] * 2,
                        dtype=torch.int32, device=dev)
  res = {}

  err = 0.0
  for length in (full, ragged):
    out, stats = pqd.pq_decode_attention(q, kcb, vcb, kidx, vidx, length,
                                         scale)
    ref_out, ref_stats = pqd.pq_decode_attention_plain(
        q, kcb, vcb, kidx, vidx, length, scale)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
      raise AssertionError("K1 output is not finite")
    e = float((out - ref_out).abs().max())
    torch.testing.assert_close(stats, ref_stats, atol=KERNEL_ATOL, rtol=1e-4)
    empty = length == 0
    if empty.any() and (out[empty].abs().max() != 0
                        or (stats[empty, 1] != 0).any()):
      raise AssertionError("K1 empty rows must give out 0 and denom 0")
    err = max(err, e)
  if not err <= KERNEL_ATOL:
    raise AssertionError(f"K1 max abs err {err} > {KERNEL_ATOL}")
  ms = cuda_time_ms(lambda: pqd.pq_decode_attention(
      q, kcb, vcb, kidx, vidx, full, scale))
  plain_ms = cuda_time_ms(lambda: pqd.pq_decode_attention_plain(
      q, kcb, vcb, kidx, vidx, full, scale))
  tokens = int(full.sum())
  nbytes = (q.numel() * 2 + (kcb.numel() + vcb.numel()) * 2
            + 2 * tokens * m * 2 + bh * 4 + bh * g * d * 4 + bh * 2 * g * 4)
  ops = tokens * g * d * 2 * 2          # scores and value contraction, FMA = 2
  b_ms, b_by = bound(nbytes, ops, torch.bfloat16)
  res["pq_decode_attention"] = dict(
      name="pq_decode_attention", route="cuda",
      source="src/repro_torch/csrc/pq_decode.cu",
      replaces="src/repro/kernels/pq_decode.py:179", max_abs_err=err,
      tolerance=KERNEL_ATOL, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
      bound_by=b_by, library_ms=None)
  print(f"{tag} K1 pq_decode_attention: max_abs_err {err:.3e} (tol "
        f"{KERNEL_ATOL}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
        f"{b_ms * 1e3:.3f} us ({b_by}) library n/a")

  # K2 at the exact policy's shapes: capacity prompt + gen, bf16 K/V
  cap = PROMPT + GEN
  kk, vv = randn(bh, cap, d), randn(bh, cap, d)
  full2 = torch.full((bh,), PROMPT + 1, dtype=torch.int32, device=dev)
  ragged2 = torch.tensor([0, 1, 63, 64, 65, 517, 1000, cap] * 2,
                         dtype=torch.int32, device=dev)
  err = 0.0
  for length in (full2, ragged2):
    out = pfd.flash_decode(q, kk, vv, length, scale)
    ref = pfd.flash_decode_plain(q, kk, vv, length, scale)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
      raise AssertionError("K2 output is not finite")
    err = max(err, float((out - ref).abs().max()))
  if not err <= KERNEL_ATOL:
    raise AssertionError(f"K2 max abs err {err} > {KERNEL_ATOL}")
  ms = cuda_time_ms(lambda: pfd.flash_decode(q, kk, vv, full2, scale))
  plain_ms = cuda_time_ms(lambda: pfd.flash_decode_plain(q, kk, vv, full2,
                                                         scale))
  mask = (torch.arange(cap, device=dev)[None, :]
          < full2[:, None])[:, None, None, :]
  sdpa = torch.nn.functional.scaled_dot_product_attention
  library_ms = cuda_time_ms(lambda: sdpa(
      q[:, None], kk[:, None], vv[:, None], attn_mask=mask, scale=scale))
  tokens = int(full2.sum())
  nbytes = q.numel() * 2 + 2 * tokens * d * 2 + bh * 4 + bh * g * d * 4
  ops = tokens * g * d * 2 * 2
  b_ms, b_by = bound(nbytes, ops, torch.bfloat16)
  res["flash_decode"] = dict(
      name="flash_decode", route="cuda",
      source="src/repro_torch/csrc/flash_decode.cu",
      replaces="src/repro/kernels/paged_flash_decode.py:115",
      max_abs_err=err, tolerance=KERNEL_ATOL, ms=ms, plain_ms=plain_ms,
      bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
  print(f"{tag} K2 flash_decode: max_abs_err {err:.3e} (tol {KERNEL_ATOL}) "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
        f"{b_ms * 1e3:.3f} us ({b_by}) library (sdpa) {library_ms:.4f} ms")
  return res


def serve_phase(dev, tag) -> dict:
  """Full-width serve through ServeRun; counters prove the kernels ran."""
  from repro_torch.kernels import paged_flash_decode as pfd
  from repro_torch.kernels import pq_decode as pqd
  from repro_torch.launch.serve import ServeRun

  counters = {"pq": pqd.pq_decode_attention, "exact": pfd.flash_decode}
  models = {}
  pqd.pq_decode_attention.launches = 0
  pfd.flash_decode.launches = 0
  for policy in ("pq", "exact"):
    run = ServeRun(arch=ARCH, reduced=False, batch=BATCH, prompt_len=PROMPT,
                   gen=GEN, cache_policy=policy, decode_kernel="auto",
                   device=str(dev), seed=0)
    model = run.build()
    cfg = model.cfg
    before = {p: c.launches for p, c in counters.items()}
    torch.cuda.reset_peak_memory_stats(dev)
    res = run.run(model)
    peak = torch.cuda.max_memory_allocated(dev)
    steps = 1 + 2 * GEN          # warmup step, timed loop, latency pass
    grew = {p: c.launches - before[p] for p, c in counters.items()}
    want = {p: (steps * cfg.n_layers if p == policy else 0) for p in counters}
    if grew != want:
      raise AssertionError(f"{policy}: kernel launches {grew} != {want} "
                           f"({steps} decode steps x {cfg.n_layers} layers)")
    toks = res["tokens"]
    if toks.shape != (BATCH, GEN) or toks.min() < 0 or \
        toks.max() >= cfg.vocab_size:
      raise AssertionError(f"{policy}: bad tokens {toks.shape}")
    if res["decode_kernel"] != "cuda":
      raise AssertionError(f"{policy}: decode ran {res['decode_kernel']}")
    print(f"{tag} serve {policy}: prefill {res['prefill_s']:.4f} s decode "
          f"{res['tok_per_s']:.2f} tok/s step p50 "
          f"{res['decode_step_p50_ms']:.4f} ms p99 "
          f"{res['decode_step_p99_ms']:.4f} ms peak mem "
          f"{peak / 2**30:.3f} GiB kernel launches {grew[policy]} "
          f"({steps} steps x {cfg.n_layers} layers)")
    print(f"{tag} serve {policy} sample tokens: {toks[0].tolist()}")
    models[policy] = (run, model)
  return models


def parity_phase(models, tag) -> None:
  """cuda vs torch dispatch from one prefilled cache, teacher-forced."""
  for policy, (run, model) in models.items():
    cfg = model.cfg
    cuda_policy = model.cache_policy
    torch_policy = dataclasses.replace(
        cfg, decode_kernel="torch").make_cache_policy(model.context_len,
                                                      model.device)
    prompts = run.prompts(cfg.vocab_size).to(model.device)
    logits, cache = model.prefill(prompts)
    tok = torch.argmax(logits, -1)
    cache_c, cache_t = cache, cache
    worst, checked = 0.0, 0
    for i in range(PARITY_STEPS):
      lengths = torch.full((BATCH,), PROMPT + i, dtype=torch.int32,
                           device=model.device)
      model.cache_policy = cuda_policy
      lc, cache_c = model.decode_step(tok, cache_c, lengths)
      model.cache_policy = torch_policy
      lt, cache_t = model.decode_step(tok, cache_t, lengths)
      model.cache_policy = cuda_policy
      lc, lt = lc.float(), lt.float()
      if not torch.isfinite(lc).all():
        raise AssertionError(f"{policy}: non-finite logits")
      worst = max(worst, float((lc - lt).abs().max()))
      top2 = torch.topk(lt, 2, dim=-1).values
      decisive = (top2[:, 0] - top2[:, 1]) > LOGIT_ATOL
      if (torch.argmax(lc, -1) != torch.argmax(lt, -1))[decisive].any():
        raise AssertionError(f"{policy}: tokens differ at step {i}")
      checked += int(decisive.sum())
      tok = torch.argmax(lt, -1)      # teacher-forced on the plain path
    if not worst <= LOGIT_ATOL:
      raise AssertionError(f"{policy}: cuda vs torch logits differ by "
                           f"{worst} > {LOGIT_ATOL}")
    print(f"{tag} parity {policy}: cuda vs torch dispatch, "
          f"{PARITY_STEPS} steps, max |dlogit| {worst:.4f} (tol "
          f"{LOGIT_ATOL}), {checked} decisive tokens equal")


def profile_phase(models, tag) -> None:
  """Where a decode step's time goes: device busy share and top kernels."""
  from torch.profiler import ProfilerActivity, profile
  steps = 3
  for policy, (run, model) in models.items():
    prompts = run.prompts(model.cfg.vocab_size).to(model.device)
    logits, cache = model.prefill(prompts)
    tok = torch.argmax(logits, -1)
    lengths = torch.full((BATCH,), PROMPT, dtype=torch.int32,
                         device=model.device)
    model.decode_step(tok, cache, lengths)          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      for _ in range(steps):
        model.decode_step(tok, cache, lengths)
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for e in prof.key_averages():
      # kernel rows only: a CPU op's self device time repeats its kernels'
      if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0:
        rows.append((e.self_device_time_total / steps / 1e3,
                     e.count / steps, e.key))
    busy = sum(r[0] for r in rows)
    if not rows:
      print(f"{tag} profile {policy}: the profiler saw no device time "
            f"(not measured)")
      continue
    print(f"{tag} profile {policy}: step {wall_ms:.3f} ms (profiled), "
          f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{sum(r[1] for r in rows):.0f} kernels per step")
    for ms, count, name in sorted(rows, reverse=True)[:8]:
      print(f"{tag}   {ms:.4f} ms/step  {count:.0f}x  {name[:90]}")


def main() -> int:
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs on the card only",
          file=sys.stderr)
    return 1
  try:
    from repro_torch.kernels import _build
  except ImportError as e:
    print(f"chip_smoke: the repro_torch package is missing ({e})",
          file=sys.stderr)
    return 1
  dev = torch.device("cuda", 0)
  card = smi_line()
  tag = f"[{card}]"
  print(card)
  print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")

  t0 = time.monotonic()
  logs = _build.build_all()
  print(f"{tag} kernels built in {time.monotonic() - t0:.2f} s")
  for name, log in logs.items():
    for line in log.splitlines():
      if "registers" in line or "spill" in line:
        print(f"  {name}: {line.strip()}")

  t0 = time.monotonic()
  kernels = kernel_phase(dev, tag)
  print(f"{tag} kernel phase {time.monotonic() - t0:.2f} s")
  t0 = time.monotonic()
  models = serve_phase(dev, tag)
  print(f"{tag} serve phase {time.monotonic() - t0:.2f} s")
  from repro_torch.kernels import paged_flash_decode as pfd
  from repro_torch.kernels import pq_decode as pqd
  kernels["pq_decode_attention"]["launches"] = pqd.pq_decode_attention.launches
  kernels["flash_decode"]["launches"] = pfd.flash_decode.launches
  t0 = time.monotonic()
  parity_phase(models, tag)
  print(f"{tag} parity phase {time.monotonic() - t0:.2f} s")
  t0 = time.monotonic()
  profile_phase(models, tag)
  print(f"{tag} profile phase {time.monotonic() - t0:.2f} s")

  print(json.dumps({"kernels": list(kernels.values())}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
