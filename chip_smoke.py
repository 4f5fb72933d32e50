"""On-card smoke test of the PyTorch + CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card (built for an H100, sm_90a) and the CUDA toolkit.  It

  1. builds the kernels from `src/repro_torch/csrc/` (one `nvcc` per
     source, all started together) into `build/repro_torch/`;
  2. holds each kernel against its plain PyTorch version on the card at the
     full-width shapes its path gives it (K1/K2 the contiguous serve path,
     K2 on the bf16 store and on the f32 store of the exact q4 path, each
     of its two steps against its plain version and two calls bit-equal;
     K3/K4/K5 the paged engine path: layer 21 of 22, shuffled block tables
     with trash entries, ragged lengths, K3's and K5's split and merge steps
     each against their plain versions, two K3 and two K5 calls bit-equal,
     K3 within 1e-4 of K1 on the gathered view and K5 within 1e-4 of K4 on
     the dequantized pools; K6 the pq prefill's k-means at R = 512
     and R = 128, also with planted ties, NaN and inf; B0 (the k-means
     update) at R = 512 and R = 128, bf16 and f32 points, with empty
     clusters, zero weights, one cluster, K > N and 16k-token bodies at
     dsub 2 and 4, two calls bit-equal; K7 the
     prefill attention of `ServeRun` and of an engine admission, a ragged N,
     a non-causal and an f32 case; K8 the contiguous q4 store) and times
     kernel, plain version, the bound and (where one exists) a single
     PyTorch library call, printing K2's and K7's factor over that call,
     each kernel's share of the bound, and K3's, K5's and K6's times
     before their redesign;
  3. serves full-width tinyllama-1.1b (random bf16 weights from a seed)
     through `ServeRun` with the `pq` policy, the `exact` policy and the
     `exact` policy on its packed q4 store, batch 4, prompt 1024, 16
     generated tokens, and the four baselines (`streamingllm`, `skvq`,
     `snapkv`, `pqcache`) with 4 generated tokens, and `exact` once more
     at prompt 1000 (a length no tile or block divides), and checks from the
     launch counters that every layer of every prefill ran K7, every layer
     of every decode step ran its kernels (K1; K2; K8 and K2; none for the
     baselines but `pqcache`'s index build through K6 and B0) and every
     k-means assignment of every pq prefill ran K6 and every update B0 (and
     none the plain one-hot update);
  4. serves it through the continuous-batching `ServeEngine` on the paged
     layout with the paged scheduler (the `--engine` CLI demo: 6 requests of
     1024 down to 939 prompt tokens, 16 new tokens each, 4 slots), for
     `pq`, `exact`, `exact` on the packed q4 store, `pq` with a pool cut
     so the scheduler must preempt, and `streamingllm` (window 512: blocks
     that age out are freed), and checks that every layer of every
     admission's prefill ran K7, every decode step K3, K4 or K5 (the
     baseline: the dense gather program, no kernel) and every pq admission
     K6 and B0;
  5. parity, cuda against torch dispatch: prefill logits of `pq`,
     `exact` (prompts of 1024 and of 1000), `exact` q4 and `snapkv`, and
     `Model.forward` logits of one
     1024-token sequence (K7 against the plain attention); from one
     prefilled cache per policy, 4 teacher-forced decode steps on the
     contiguous layout (`Model.decode_step`) and on the paged layout
     (block-native program against the dense gather program); for `pq` and
     `snapkv` also from each dispatch's own prefill (K6 and K7 against the
     plain versions);
  6. profiles 3 decode steps per policy and layout (`torch.profiler`):
     device busy share and the kernels that take the device time; then one
     pq prefill of `ServeRun` (batch 4) and one of an engine admission
     (batch 1): device busy share, K6's, B0's and the k-means update's
     device time, the largest device entries, and in a second call the wall
     seconds spent in K6 and in `weighted_update` (a synchronize around each
     call).

Every check that fails raises, so the script exits non-zero.  The last line
is a JSON object naming the device; the line before it the card's name and
power limit, and the one before that lists the kernels.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "tinyllama-1.1b"
BATCH, PROMPT, GEN = 4, 1024, 16
BASELINES = ("streamingllm", "skvq", "snapkv", "pqcache")
BASELINE_GEN = 4
# a prompt that no 64-row tile or 512-token block divides: its prefill must
# run K7 in every layer all the same
RAGGED_PROMPT = 1000
RAGGED_LABEL = f"exact prompt {RAGGED_PROMPT}"
PARITY_STEPS = 4
N_LAYERS = 22
# k-means assignments per pq prefill: (iters 4 + 1) per codebook, K and V,
# in every layer
K6_PER_PREFILL = 5 * 2 * N_LAYERS
CODEC = "q4"                       # the packed store the q4 runs serve
# the paged engine path: `python -m repro_torch.launch.serve --engine ...`
# (context 1056 = 66 blocks of 16; the pq body holds 1024 = 64 blocks)
ENGINE_ARGS = ["--arch", ARCH, "--engine", "--cache-layout", "paged",
               "--scheduler", "paged", "--batch", str(BATCH), "--prompt-len",
               str(PROMPT), "--gen", "32", "--device", "cuda"]
ENGINE_REQUESTS = BATCH + 2
BLK = 16
# a pq pool that admits the two longest prompts (bodies of 984 and 967
# tokens: 62 + 61 blocks) with one block left, so their growth runs it dry
# and the paged scheduler must preempt
PREEMPT_BLOCKS = 124
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
# dense, per s; f16/bf16 on the tensor cores, f32 on the CUDA cores (also
# the rate the integer operations of K8 are counted at)
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}
# Kernel vs plain version, both f32 accumulation over the same bf16 inputs;
# only the order of the f32 sums differs.
KERNEL_ATOL = 1e-4
# K7 is held to its plain version element by element within
# `flash_attention.kernel_error_bound`: for bf16 inputs 2^-8 x the plain
# attention of |v| (P rounded to bf16 for the PV product) + 2^-7 x |plain|
# (the output's bf16 rounding) + 1e-5, at most 3e-2 (the reference's bf16
# limit); for f32 inputs (FMA, no TF32) 1e-5.
# K3's and K6's times before their redesign (the one-pass K3 and the
# one-point-per-thread K6; PERF.md section 6, NVIDIA H100 80GB HBM3, 700.00 W)
K3_BEFORE_MS, K6_BEFORE_MS = 0.19777408599853516, 0.17291584014892578
# pqcache's index build: (iters 4 + 1) assignments per layer per decode step
K6_PER_PQCACHE_STEP = 5 * N_LAYERS
# k-means updates (B0): iters 4 per codebook, K and V, in every layer of a
# pq prefill; 4 per layer per pqcache decode step
B0_PER_PREFILL = 4 * 2 * N_LAYERS
B0_PER_PQCACHE_STEP = 4 * N_LAYERS
# K5's time before its redesign (one block per (batch, kv head) on K4's
# body; PERF.md section 6, NVIDIA H100 80GB HBM3, 700.00 W)
K5_BEFORE_MS = 0.3158284759521484
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


def device_ms(fn, kernels, calls: int = 20) -> float:
  """Device milliseconds per call of fn in the kernels whose names contain
  one of `kernels` (`torch.profiler`, `calls` calls after one warm-up)."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
      fn()
    torch.cuda.synchronize()
  return sum(e.self_device_time_total for e in prof.key_averages()
             if any(k in e.key for k in kernels)) / calls / 1e3


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

  # K2 at the exact policy's shapes: capacity prompt + gen, K/V bf16 (the
  # exact store) or f32 (the exact q4 store, dequantized through K8)
  cap = PROMPT + GEN
  full2 = torch.full((bh,), PROMPT + 1, dtype=torch.int32, device=dev)
  ragged2 = torch.tensor([0, 1, 63, 64, 65, 517, 1000, cap] * 2,
                         dtype=torch.int32, device=dev)
  n_split, chunk = pfd.flash_decode_split(
      bh, cap, torch.cuda.get_device_properties(dev).multi_processor_count)
  sdpa = torch.nn.functional.scaled_dot_product_attention
  k2 = {}
  for dtype in (torch.bfloat16, torch.float32):
    qd = q.to(dtype)
    kk, vv = randn(bh, cap, d, dtype=dtype), randn(bh, cap, d, dtype=dtype)
    err = 0.0
    for length in (full2, ragged2):
      out = pfd.flash_decode(qd, kk, vv, length, scale)
      again = pfd.flash_decode(qd, kk, vv, length, scale)
      ref = pfd.flash_decode_plain(qd, kk, vv, length, scale)
      torch.cuda.synchronize()
      if not torch.isfinite(out).all():
        raise AssertionError("K2 output is not finite")
      if not torch.equal(out, again):
        raise AssertionError(f"K2 ({dtype}): two calls on the same inputs "
                             f"differ")
      empty = length == 0
      if empty.any() and out[empty].abs().max() != 0:
        raise AssertionError("K2 empty rows must give out 0")
      err = max(err, float((out - ref).abs().max()))
      # each step against its plain version, the merge on the kernel's own
      # partials
      acc, stats = pfd.flash_decode_partials(qd, kk, vv, length, scale,
                                             n_split, chunk)
      p_acc, p_stats = pfd.flash_decode_partials_plain(
          qd, kk, vv, length, scale, n_split, chunk)
      torch.testing.assert_close(acc, p_acc, atol=KERNEL_ATOL, rtol=1e-4)
      torch.testing.assert_close(stats, p_stats, atol=KERNEL_ATOL, rtol=1e-4)
      merge_err = float((pfd.flash_decode_merge(acc, stats)
                         - pfd.flash_decode_merge_plain(acc, stats)
                         ).abs().max())
      if not merge_err <= KERNEL_ATOL:
        raise AssertionError(f"K2 merge differs from the plain merge by "
                             f"{merge_err}")
    if not err <= KERNEL_ATOL:
      raise AssertionError(f"K2 ({dtype}) max abs err {err} > {KERNEL_ATOL}")
    ms = cuda_time_ms(lambda: pfd.flash_decode(qd, kk, vv, full2, scale))
    plain_ms = cuda_time_ms(lambda: pfd.flash_decode_plain(qd, kk, vv, full2,
                                                           scale))
    mask = (torch.arange(cap, device=dev)[None, :]
            < full2[:, None])[:, None, None, :]
    library_ms = cuda_time_ms(lambda: sdpa(
        qd[:, None], kk[:, None], vv[:, None], attn_mask=mask, scale=scale))
    tokens = int(full2.sum())
    size = kk.element_size()
    nbytes = qd.numel() * size + 2 * tokens * d * size + bh * 4 + bh * g * d * 4
    ops = tokens * g * d * 2 * 2
    b_ms, b_by = bound(nbytes, ops, dtype)
    k2[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=library_ms)
    print(f"{tag} K2 flash_decode ({str(dtype).replace('torch.', '')}, split "
          f"S {n_split} x {chunk} tokens): max_abs_err {err:.3e} (tol "
          f"{KERNEL_ATOL}), two calls bit-equal, merge within "
          f"{KERNEL_ATOL} of the plain merge; kernel {ms:.4f} ms plain "
          f"{plain_ms:.4f} ms bound {b_ms * 1e3:.3f} us ({b_by}) library "
          f"(sdpa + mask) {library_ms:.4f} ms; {ms / library_ms:.3f}x the "
          f"library, {b_ms / ms:.4f} of the bound")
  bf = k2[torch.bfloat16]
  res["flash_decode"] = dict(
      name="flash_decode", route="cuda",
      source="src/repro_torch/csrc/flash_decode.cu",
      replaces="src/repro/kernels/paged_flash_decode.py:115",
      max_abs_err=max(c["max_abs_err"] for c in k2.values()),
      tolerance=KERNEL_ATOL, bit_equal_calls=True, split=[n_split, chunk],
      ms=bf["ms"], plain_ms=bf["plain_ms"], bound_ms=bf["bound_ms"],
      bound_by=bf["bound_by"], library_ms=bf["library_ms"],
      f32=k2[torch.float32])
  return res


def _paged_tables(gen, dev, lengths, nb, pool_blocks):
  """(B, nb) int32: a seeded permutation of pool ids, with the trash block
  (= pool_blocks) past each row's length."""
  b = lengths.shape[0]
  perm = torch.randperm(pool_blocks, generator=gen, device=dev)[:b * nb]
  tables = perm.reshape(b, nb).to(torch.int32)
  past = (torch.arange(nb, device=dev)[None, :]
          >= (-(-lengths.long() // BLK))[:, None])
  return tables.masked_fill(past, pool_blocks)


def paged_kernel_phase(dev, tag) -> dict:
  """K3 and K4 against their plain versions at the paged engine path's
  shapes: the engine's first batch (prompts 1024, 1007, 990, 973), layer
  21 of 22, pools of 4x a request's blocks, shuffled tables."""
  from repro_torch.kernels import paged_flash_decode as pfd
  from repro_torch.kernels import pq_decode as pqd

  gen = torch.Generator(device=dev).manual_seed(1)
  b, h, g, d, m = BATCH, 4, 8, 64, 32
  bh, dsub, scale, layer = b * h, d // m, d ** -0.5, N_LAYERS - 1
  prompts = torch.tensor([PROMPT - 17 * i for i in range(b)],
                         dtype=torch.int32, device=dev)
  q = torch.randn(bh, g, d, generator=gen, device=dev).to(torch.bfloat16)
  res = {}

  # K3: the pq body, 64 blocks per request; int16 at K = 512, uint8 at 256
  nb = 1024 // BLK
  pool_blocks = 4 * nb
  body = prompts - 40                         # sink 8 + recent 32
  ragged = torch.tensor([0, 1, 517, nb * BLK], dtype=torch.int32, device=dev)
  errs, inputs = {}, {}
  for k_cent, idx_dtype in ((512, torch.int16), (256, torch.uint8)):
    kcb, vcb = (torch.randn(bh, m, k_cent, dsub, generator=gen, device=dev
                            ).to(torch.bfloat16) for _ in range(2))
    shape = (pool_blocks + 1, N_LAYERS, h, BLK, m)
    kp, vp = (torch.randint(0, k_cent, shape, generator=gen, device=dev
                            ).to(idx_dtype) for _ in range(2))
    inputs[k_cent] = (kcb, vcb, kp, vp)
    errs[k_cent] = 0.0
    for length in (body, ragged):
      tables = _paged_tables(gen, dev, length, nb, pool_blocks)
      out, stats = pqd.pq_decode_attention_paged(q, kcb, vcb, kp, vp, tables,
                                                 layer, length, scale)
      ref_out, ref_stats = pqd.pq_decode_attention_paged_plain(
          q, kcb, vcb, kp, vp, tables, layer, length, scale)
      torch.cuda.synchronize()
      if not torch.isfinite(out).all():
        raise AssertionError("K3 output is not finite")
      torch.testing.assert_close(stats, ref_stats, atol=KERNEL_ATOL,
                                 rtol=1e-4)
      empty = (length == 0).repeat_interleave(h)
      if empty.any() and (out[empty].abs().max() != 0
                          or (stats[empty, 1] != 0).any()
                          or (stats[empty, 0] != pqd.NEG_INF).any()):
        raise AssertionError("K3 empty rows must give out 0, max -1e30 and "
                             "denom 0")
      errs[k_cent] = max(errs[k_cent], float((out - ref_out).abs().max()))
  err, err_u8 = errs[512], errs[256]
  if not max(err, err_u8) <= KERNEL_ATOL:
    raise AssertionError(f"K3 max abs err {err} / uint8 {err_u8} > "
                         f"{KERNEL_ATOL}")
  kcb, vcb, kp, vp = inputs[512]
  tables = _paged_tables(gen, dev, body, nb, pool_blocks)
  args = (q, kcb, vcb, kp, vp, tables, layer, body, scale)
  # two calls bit-equal; each step against its plain version (the merge on
  # the split kernel's own partials); K1 on the gathered dense view
  n_split, chunk = pqd.pq_decode_paged_split(
      bh, nb * BLK, torch.cuda.get_device_properties(dev).multi_processor_count)
  out, stats = pqd.pq_decode_attention_paged(*args)
  again = pqd.pq_decode_attention_paged(*args)
  acc, pst = pqd.pq_decode_paged_partials(*args, n_split, chunk)
  p_acc, p_pst = pqd.pq_decode_paged_partials_plain(*args, n_split, chunk)
  m_out, m_st = pqd.pq_decode_paged_merge(acc, pst)
  w_out, w_st = pqd.pq_decode_paged_merge_plain(acc, pst)
  dense = [x[:, layer][tables.long()].permute(0, 2, 1, 3, 4).reshape(
      bh, nb * BLK, m).contiguous() for x in (kp, vp)]
  out1, stats1 = pqd.pq_decode_attention(q, kcb, vcb, dense[0], dense[1],
                                         body.repeat_interleave(h), scale)
  torch.cuda.synchronize()
  if not (torch.equal(out, again[0]) and torch.equal(stats, again[1])):
    raise AssertionError("K3: two calls on the same inputs differ")
  # the stats hold denominators of up to ~1e3: held as the card tests hold
  # them, within 1e-4 absolute plus 1e-4 relative
  for a, w in ((acc, p_acc), (pst, p_pst), (m_out, w_out), (m_st, w_st),
               (out, out1), (stats, stats1)):
    torch.testing.assert_close(a, w, atol=KERNEL_ATOL, rtol=1e-4)
  step_err = max(float((acc - p_acc).abs().max()),
                 float((m_out - w_out).abs().max()))
  k1_err = float((out - out1).abs().max())
  ms = cuda_time_ms(lambda: pqd.pq_decode_attention_paged(*args))
  dev_ms = device_ms(lambda: pqd.pq_decode_attention_paged(*args),
                     ("pq_decode_split_kernel", "pq_decode_merge_kernel"))
  plain_ms = cuda_time_ms(lambda: pqd.pq_decode_attention_paged_plain(*args))
  tokens = int(body.sum()) * h
  nbytes = (q.numel() * 2 + (kcb.numel() + vcb.numel()) * 2
            + 2 * tokens * m * 2 + tables.numel() * 4 + b * 4
            + bh * g * d * 4 + bh * 2 * g * 4)
  ops = tokens * g * d * 2 * 2
  b_ms, b_by = bound(nbytes, ops, torch.bfloat16)
  res["pq_decode_attention_paged"] = dict(
      name="pq_decode_attention_paged", route="cuda",
      source="src/repro_torch/csrc/pq_decode_paged.cu",
      replaces="src/repro/kernels/pq_decode.py:289", max_abs_err=err,
      max_abs_err_uint8=err_u8, tolerance=KERNEL_ATOL, bit_equal_calls=True,
      split=[n_split, chunk], step_err=step_err, k1_err=k1_err, ms=ms,
      device_ms=dev_ms, before_ms=K3_BEFORE_MS, plain_ms=plain_ms,
      bound_ms=b_ms, bound_by=b_by, library_ms=None)
  print(f"{tag} K3 pq_decode_attention_paged (split S {n_split} x {chunk} "
        f"tokens): max_abs_err {err:.3e} (int16, K=512; uint8, K=256: "
        f"{err_u8:.3e}; tol {KERNEL_ATOL}), two calls bit-equal, steps' "
        f"outputs within {step_err:.3e} of their plain versions, out within "
        f"{k1_err:.3e} of K1; kernel {ms:.4f} ms a call (before the "
        f"redesign: {K3_BEFORE_MS}), of it {dev_ms:.4f} ms on the device "
        f"(split + merge) plain {plain_ms:.4f} ms bound {b_ms * 1e3:.3f} us "
        f"({b_by}), {b_ms / ms:.4f} of the bound ({b_ms / dev_ms:.4f} of the "
        f"device time); library n/a")

  # K4: exact K/V pools, 66 blocks per request (context 1056), bf16
  nb = (PROMPT + 32) // BLK
  pool_blocks = 4 * nb
  shape = (pool_blocks + 1, N_LAYERS, h, BLK, d)
  kp, vp = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
  cached = prompts + 1
  ragged = torch.tensor([0, 1, 517, nb * BLK], dtype=torch.int32, device=dev)
  err = 0.0
  for length in (cached, ragged):
    tables = _paged_tables(gen, dev, length, nb, pool_blocks)
    out = pfd.paged_flash_decode(q, kp, vp, tables, layer, length, scale)
    ref = pfd.paged_flash_decode_plain(q, kp, vp, tables, layer, length,
                                       scale)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
      raise AssertionError("K4 output is not finite")
    empty = (length == 0).repeat_interleave(h)
    if empty.any() and out[empty].abs().max() != 0:
      raise AssertionError("K4 empty rows must give out 0")
    err = max(err, float((out - ref).abs().max()))
  if not err <= KERNEL_ATOL:
    raise AssertionError(f"K4 max abs err {err} > {KERNEL_ATOL}")
  tables = _paged_tables(gen, dev, cached, nb, pool_blocks)
  ms = cuda_time_ms(lambda: pfd.paged_flash_decode(q, kp, vp, tables, layer,
                                                   cached, scale))
  plain_ms = cuda_time_ms(lambda: pfd.paged_flash_decode_plain(
      q, kp, vp, tables, layer, cached, scale))
  tokens = int(cached.sum()) * h
  nbytes = (q.numel() * 2 + 2 * tokens * d * 2 + tables.numel() * 4 + b * 4
            + bh * g * d * 4)
  ops = tokens * g * d * 2 * 2
  b_ms, b_by = bound(nbytes, ops, torch.bfloat16)
  res["paged_flash_decode"] = dict(
      name="paged_flash_decode", route="cuda",
      source="src/repro_torch/csrc/paged_flash_decode.cu",
      replaces="src/repro/kernels/paged_flash_decode.py:192",
      max_abs_err=err, tolerance=KERNEL_ATOL, ms=ms, plain_ms=plain_ms,
      bound_ms=b_ms, bound_by=b_by, library_ms=None)
  print(f"{tag} K4 paged_flash_decode: max_abs_err {err:.3e} (tol "
        f"{KERNEL_ATOL}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
        f"{b_ms * 1e3:.3f} us ({b_by}) library n/a")
  return res


def packed_kernel_phase(dev, tag) -> dict:
  """K5 and K8 against their plain versions: K5 at the paged q4 engine
  path's shapes (the engine's first batch, layer 21 of 22, shuffled tables)
  for bits 4, 5 and 8, two calls bit-equal, its split step against its plain
  version and K2's merge on its partials against the plain merge, and
  within 1e-4 of K4 on the f32 pools the plain dequant gives (K5 splits the
  pages, K4 sums in one pass); K8 at the contiguous q4 store of
  `ServeRun`."""
  from repro_torch.kernels import packing
  from repro_torch.kernels import paged_flash_decode as pfd

  gen = torch.Generator(device=dev).manual_seed(2)
  b, h, g, d = BATCH, 4, 8, 64
  bh, scale, layer = b * h, d ** -0.5, N_LAYERS - 1
  group = packing.group_size(d)
  n_groups = d // group
  cached = torch.tensor([PROMPT + 1 - 17 * i for i in range(b)],
                        dtype=torch.int32, device=dev)
  ragged = torch.tensor([0, 1, 517, 1056], dtype=torch.int32, device=dev)
  q = torch.randn(bh, g, d, generator=gen, device=dev).to(torch.bfloat16)
  nb = (PROMPT + 32) // BLK
  pool_blocks = 4 * nb
  shape = (pool_blocks + 1, N_LAYERS, h, BLK)
  n_split, chunk = pfd.flash_decode_split(
      bh, nb * BLK, torch.cuda.get_device_properties(dev).multi_processor_count)
  res, errs, k4_errs, step_errs, inputs = {}, {}, {}, {}, {}
  for bits in (4, 5, 8):
    pools = []
    for _ in range(2):      # K, then V: codes, scale, min from normal draws
      x = torch.randn(shape + (d,), generator=gen, device=dev)
      pools += list(packing.pack_rows(x, bits=bits, group=group))
    del x
    kf = packing.dequant_page(*pools[:3], bits=bits, group=group)
    vf = packing.dequant_page(*pools[3:], bits=bits, group=group)
    errs[bits] = k4_errs[bits] = step_errs[bits] = 0.0
    for length in (cached, ragged):
      tables = _paged_tables(gen, dev, length, nb, pool_blocks)
      args = (q, *pools, tables, layer, length, scale, bits)
      out = pfd.packed_paged_flash_decode(*args)
      again = pfd.packed_paged_flash_decode(*args)
      ref = pfd.packed_paged_flash_decode_plain(*args)
      out4 = pfd.paged_flash_decode(q.float(), kf, vf, tables, layer, length,
                                    scale)
      acc, st = pfd.packed_paged_flash_decode_partials(*args, n_split, chunk)
      p_acc, p_st = pfd.packed_paged_flash_decode_partials_plain(
          *args, n_split, chunk)
      merged = pfd.flash_decode_merge(acc, st)
      p_merged = pfd.flash_decode_merge_plain(acc, st)
      torch.cuda.synchronize()
      if not torch.isfinite(out).all():
        raise AssertionError(f"K5 (bits {bits}) output is not finite")
      if not (torch.equal(out, again) and torch.equal(out, merged)):
        raise AssertionError(f"K5 (bits {bits}): two calls on the same "
                             f"inputs differ, or differ from K2's merge of "
                             f"its own partials")
      # the stats hold denominators of up to ~1e3: held as the card tests
      # hold them, within 1e-4 absolute plus 1e-4 relative
      for a, w in ((out, out4), (acc, p_acc), (st, p_st), (merged, p_merged)):
        torch.testing.assert_close(a, w, atol=KERNEL_ATOL, rtol=1e-4)
      empty = (length == 0).repeat_interleave(h)
      if empty.any() and out[empty].abs().max() != 0:
        raise AssertionError("K5 empty rows must give out 0")
      errs[bits] = max(errs[bits], float((out - ref).abs().max()))
      k4_errs[bits] = max(k4_errs[bits], float((out - out4).abs().max()))
      step_errs[bits] = max(step_errs[bits],
                            float((acc - p_acc).abs().max()),
                            float((merged - p_merged).abs().max()))
    inputs[bits] = pools
    del kf, vf
  if not max(errs.values()) <= KERNEL_ATOL:
    raise AssertionError(f"K5 max abs err {errs} > {KERNEL_ATOL}")
  pools = inputs[4]
  tables = _paged_tables(gen, dev, cached, nb, pool_blocks)
  ms = cuda_time_ms(lambda: pfd.packed_paged_flash_decode(
      q, *pools, tables, layer, cached, scale, 4))
  dev_ms = device_ms(lambda: pfd.packed_paged_flash_decode(
      q, *pools, tables, layer, cached, scale, 4),
      ("packed_split_kernel", "flash_decode_merge_kernel"))
  plain_ms = cuda_time_ms(lambda: pfd.packed_paged_flash_decode_plain(
      q, *pools, tables, layer, cached, scale, 4))
  rows = int(cached.sum()) * h
  row_bytes = packing.packed_width(d, 4) + 2 * n_groups * 2   # codes, headers
  nbytes = (q.numel() * 2 + 2 * rows * row_bytes + tables.numel() * 4
            + b * 4 + bh * g * d * 4)
  ops = rows * g * d * 2 * 2 + 2 * rows * d * 2    # attention, dequant
  b_ms, b_by = bound(nbytes, ops, torch.float16)
  res["packed_paged_flash_decode"] = dict(
      name="packed_paged_flash_decode", route="cuda",
      source="src/repro_torch/csrc/packed_paged_flash_decode.cu",
      replaces="src/repro/kernels/paged_flash_decode.py:283",
      max_abs_err=errs[4], max_abs_err_q5=errs[5], max_abs_err_q8=errs[8],
      tolerance=KERNEL_ATOL, bit_equal_calls=True, split=[n_split, chunk],
      k4_err=max(k4_errs.values()), step_err=max(step_errs.values()), ms=ms,
      device_ms=dev_ms, before_ms=K5_BEFORE_MS, plain_ms=plain_ms,
      bound_ms=b_ms, bound_by=b_by, library_ms=None)
  print(f"{tag} K5 packed_paged_flash_decode (split S {n_split} x {chunk} "
        f"tokens, K2's merge): max_abs_err q4 {errs[4]:.3e} q5 "
        f"{errs[5]:.3e} q8 {errs[8]:.3e} (tol {KERNEL_ATOL}), two calls "
        f"bit-equal, steps within {max(step_errs.values()):.3e} of their "
        f"plain versions, within {max(k4_errs.values()):.3e} of K4 on the "
        f"dequantized pools; q4 kernel {ms:.4f} ms a call (before the "
        f"redesign: {K5_BEFORE_MS}), of it {dev_ms:.4f} ms on the device "
        f"(split + merge) plain {plain_ms:.4f} ms bound {b_ms * 1e3:.3f} us "
        f"({b_by}, {nbytes} B), {b_ms / ms:.4f} of the bound "
        f"({b_ms / dev_ms:.4f} of the device time); library n/a")
  del inputs, pools

  # K8 at ServeRun's contiguous q4 store: B * H * capacity rows of d/2 B
  n, dp = b * h * (PROMPT + GEN), packing.packed_width(d, 4)
  p = torch.randint(0, 256, (n, dp), generator=gen, device=dev,
                    dtype=torch.int32).to(torch.uint8)
  got = packing.unpack_u4_kernel(p)
  want = packing.unpack_u4(p)
  torch.cuda.synchronize()
  if not torch.equal(got, want):
    raise AssertionError("K8 differs from unpack_u4")
  ms = cuda_time_ms(lambda: packing.unpack_u4_kernel(p))
  plain_ms = cuda_time_ms(lambda: packing.unpack_u4(p))
  nbytes = n * dp + n * 2 * dp * 4
  b_ms, b_by = bound(nbytes, n * dp * 2, torch.float32)
  res["unpack_u4"] = dict(
      name="unpack_u4", route="cuda", source="src/repro_torch/csrc/unpack_u4.cu",
      replaces="src/repro/kernels/packing.py:170", max_abs_err=0.0,
      tolerance=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
      library_ms=None)
  print(f"{tag} K8 unpack_u4 ({n} x {dp} B): equal to unpack_u4; kernel "
        f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {b_ms * 1e3:.3f} us "
        f"({b_by}, {nbytes} B) library n/a")
  return res


def _planted_k6(gen, dev, r, n, k_cent, dsub):
  """K6 inputs with exact ties (each centroid twice, a quarter of the
  points on centroids) and, in rows 0-4, a NaN point, +inf and -inf
  points, a NaN centroid, an inf centroid; row 5 overflows x . c."""
  half = torch.randn(r, k_cent // 2, dsub, generator=gen, device=dev)
  c = torch.cat([half, half.flip(1)], dim=1).contiguous()
  x = torch.randn(r, n, dsub, generator=gen, device=dev)
  on = torch.randint(0, k_cent, (r, n // 4), generator=gen, device=dev)
  x[:, ::4] = torch.gather(c, 1, on[..., None].expand(-1, -1, dsub))
  x[0, 3, 0], x[1, 5, 0], x[2, 7, 0] = float("nan"), float("inf"), -float("inf")
  c[3, k_cent // 2, 0], c[4, 0, 0] = float("nan"), float("inf")
  x[5, 9, 0], c[5, 1] = 3e38, 1e30
  return x.to(torch.bfloat16), c


def kmeans_kernel_phase(dev, tag) -> dict:
  """K6 against its plain version at the pq prefill's shapes: R = B*H*m =
  512 rows of N = 1024 body tokens against K = 512 centroids of dsub = 2
  (`ServeRun`, batch 4) and R = 128 (an engine admission, batch 1); bf16
  points (the model's keys) and f32 centroids, as the k-means hands them;
  then the same shapes with planted ties, NaN and inf.  Both shapes are
  timed."""
  from repro_torch.core import kmeans
  from repro_torch.kernels import kmeans_assign as k6
  from repro_torch.kernels import _build

  gen = torch.Generator(device=dev).manual_seed(3)
  n, k_cent, dsub = 1024, 512, 2
  agree, cases = {}, []
  for r in (BATCH * 4 * 32, 4 * 32):
    x = torch.randn(r, n, dsub, generator=gen, device=dev).to(torch.bfloat16)
    c = torch.randn(r, k_cent, dsub, generator=gen, device=dev)
    got = k6.kmeans_assign(x, c)
    want = k6.kmeans_assign_plain(x, c)
    full = kmeans.assign_clusters(x, c)
    xp, cp = _planted_k6(gen, dev, r, n, k_cent, dsub)
    got_p = k6.kmeans_assign(xp, cp)
    want_p = k6.kmeans_assign_plain(xp, cp)
    torch.cuda.synchronize()
    for label, a, w in (("", got, want), (" (planted ties, NaN, inf)", got_p,
                                          want_p)):
      if not torch.equal(a, w):
        raise AssertionError(f"K6 ids differ from the plain version at "
                             f"R={r}{label}: {int((a != w).sum())} of "
                             f"{a.numel()}")
    agree[r] = float((got == full).float().mean())
    ms = cuda_time_ms(lambda: k6.kmeans_assign(x, c))
    plain_ms = cuda_time_ms(lambda: k6.kmeans_assign_plain(x, c), iters=10)
    nbytes = x.numel() * 2 + c.numel() * 4 + r * n * 4
    # a pair: dsub products, dsub - 1 sums, a scale and a subtract; a
    # centroid's ||c||^2: dsub products and dsub - 1 sums
    ops = r * n * k_cent * (2 * dsub + 1) + r * k_cent * (2 * dsub - 1)
    b_ms, b_by = bound(nbytes, ops, torch.float32)
    lanes = k6.kmeans_assign_geometry(r, n, k_cent, _build.sm_count(dev))
    cases.append(dict(r=r, lanes=lanes, ms=ms, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by))
    before = f" (before: {K6_BEFORE_MS})" if r == BATCH * 4 * 32 else ""
    print(f"{tag} K6 kmeans_assign R={r} (lanes {lanes}): ids equal to the "
          f"plain version, also with planted ties, NaN and inf; share equal "
          f"to assign_clusters {agree[r]:.6f}; kernel {ms:.4f} ms"
          f"{before} plain "
          f"{plain_ms:.4f} ms bound {b_ms * 1e3:.3f} us ({b_by}), "
          f"{b_ms / ms:.4f} of the bound; library n/a")
    del x, c, got, want, full, xp, cp, got_p, want_p
  serve = cases[0]
  return {"kmeans_assign": dict(
      name="kmeans_assign", route="cuda",
      source="src/repro_torch/csrc/kmeans_assign.cu",
      replaces="src/repro/kernels/kmeans_assign.py:39", max_abs_err=0.0,
      tolerance=0.0, agree_with_assign_clusters=agree, ms=serve["ms"],
      before_ms=K6_BEFORE_MS, plain_ms=serve["plain_ms"],
      bound_ms=serve["bound_ms"], bound_by=serve["bound_by"],
      library_ms=None, cases=cases)}


def _b0_case(gen, dev, r, n, k_cent, dsub, x_dtype, kind):
  """B0 inputs as the prefill hands them: x (R, N, dsub), w (R, N) f32
  importance-like weights, ids (R, N) int32, old centroids (R, K, dsub) f32.
  kind: 'k6' (K6's ids of x against the centroids); 'empty' (even ids only:
  every odd cluster is empty); 'zero_w' (every 4th weight 0, as masked rows
  give them, and cluster 1 weightless); 'one' (every point in cluster 3)."""
  from repro_torch.kernels import kmeans_assign as k6
  x = torch.randn(r, n, dsub, generator=gen, device=dev).to(x_dtype)
  w = torch.rand(r, n, generator=gen, device=dev) + 0.05
  c = torch.randn(r, k_cent, dsub, generator=gen, device=dev)
  a = torch.randint(0, k_cent, (r, n), generator=gen, device=dev,
                    dtype=torch.int32)
  if kind == "k6":
    a = k6.kmeans_assign(x, c)
  elif kind == "empty":
    a = (a // 2) * 2
  elif kind == "zero_w":
    w[:, ::4] = 0
    w[a == 1] = 0
  elif kind == "one":
    a[:] = 3
  return x, w, a, c


def kmeans_update_phase(dev, tag) -> dict:
  """B0 (the k-means update) against its plain one-hot version at the pq
  prefill's shapes: R = 512 (`ServeRun`, batch 4) and R = 128 (an engine
  admission) rows of N = 1024 points against K = 512 centroids of dsub = 2,
  bf16 and f32 points, with K6's ids, empty clusters, zero weights and
  every point in one cluster; K > N (N = 100); and 16k-token bodies at
  dsub 2 and 4 (a long prompt's prefill).  Element by element
  within `kmeans_update_tolerance`, frozen clusters bit-equal to the old
  centroids, two calls bit-equal.  Timed at both prefill shapes with bf16
  points (the model's keys) and K6's ids."""
  from repro_torch.kernels import kmeans_update as b0

  torch.backends.cuda.matmul.allow_tf32 = False
  gen = torch.Generator(device=dev).manual_seed(5)
  n, k_cent, dsub = 1024, 512, 2
  share, checked, cases = 0.0, 0, []
  shapes = [(BATCH * 4 * 32, n), (4 * 32, n), (BATCH * 4 * 32, 100)]
  for r, nn in shapes:
    for x_dtype in (torch.bfloat16, torch.float32):
      for kind in ("k6", "empty", "zero_w", "one"):
        x, w, a, c = _b0_case(gen, dev, r, nn, k_cent, dsub, x_dtype, kind)
        got = b0.kmeans_update(x, w, a, c)
        again = b0.kmeans_update(x, w, a, c)
        want = b0.kmeans_update_plain(x, w, a, c)
        tol, empty = b0.kmeans_update_tolerance(x, w, a, c)
        torch.cuda.synchronize()
        label = f"R={r} N={nn} {str(x_dtype)[6:]} {kind}"
        if not torch.equal(got, again):
          raise AssertionError(f"B0 {label}: two calls on the same inputs "
                               f"differ")
        if not torch.equal(got[empty], c[empty]):
          raise AssertionError(f"B0 {label}: a frozen cluster moved")
        sh = float(((got - want).abs() / tol).max())
        if not sh <= 1.0:
          raise AssertionError(f"B0 {label}: {sh:.3f} of its bound "
                               f"(max abs err "
                               f"{float((got - want).abs().max())})")
        share = max(share, sh)
        checked += 1
        del x, w, a, c, got, again, want, tol, empty
  # long bodies: a 16k-token pq prefill at batch 1, each row one head's
  # subvector over the whole body (B0 streams it in tiles): tinyllama's
  # Hkv 4 x m 32 rows at dsub 2, and a head_dim 128 model's Hkv 8 x m 32 at
  # dsub 4.  The plain version and the tolerance run 32 rows at a time
  # (their one-hot is (R, N, K)).
  long_cases = []
  for r, nn, ds in ((4 * 32, 16384, 2), (8 * 32, 16384, 4)):
    for kind in ("k6", "one"):
      x, w, a, c = _b0_case(gen, dev, r, nn, k_cent, ds, torch.bfloat16, kind)
      got = b0.kmeans_update(x, w, a, c)
      again = b0.kmeans_update(x, w, a, c)
      label = f"R={r} N={nn} dsub {ds} bfloat16 {kind}"
      if not torch.equal(got, again):
        raise AssertionError(f"B0 {label}: two calls on the same inputs "
                             f"differ")
      sh = 0.0
      for i in range(0, r, 32):
        sl = slice(i, i + 32)
        want = b0.kmeans_update_plain(x[sl], w[sl], a[sl], c[sl])
        tol, empty = b0.kmeans_update_tolerance(x[sl], w[sl], a[sl], c[sl])
        if not torch.equal(got[sl][empty], c[sl][empty]):
          raise AssertionError(f"B0 {label}: a frozen cluster moved")
        sh = max(sh, float(((got[sl] - want).abs() / tol).max()))
        del want, tol, empty
      if not sh <= 1.0:
        raise AssertionError(f"B0 {label}: {sh:.3f} of its bound")
      share = max(share, sh)
      checked += 1
      if kind == "k6":
        ms = cuda_time_ms(lambda: b0.kmeans_update(x, w, a, c), iters=20)
        long_cases.append(dict(r=r, n=nn, dsub=ds, ms=ms, tolerance_share=sh))
        print(f"{tag} B0 kmeans_update long body R={r} (N {nn}, K {k_cent}, "
              f"dsub {ds}, bf16 x, K6's ids): kernel {ms:.4f} ms, "
              f"{sh:.4f} of kmeans_update_tolerance")
      del x, w, a, c, got, again
  err = 0.0
  for r in (BATCH * 4 * 32, 4 * 32):
    x, w, a, c = _b0_case(gen, dev, r, n, k_cent, dsub, torch.bfloat16, "k6")
    got = b0.kmeans_update(x, w, a, c)
    want = b0.kmeans_update_plain(x, w, a, c)
    err = max(err, float((got - want).abs().max()))
    ms = cuda_time_ms(lambda: b0.kmeans_update(x, w, a, c))
    plain_ms = cuda_time_ms(lambda: b0.kmeans_update_plain(x, w, a, c),
                            iters=10)
    # read x, w, the ids and the old centroids once, write the new ones
    nbytes = (x.numel() * x.element_size() + w.numel() * 4 + a.numel() * 4
              + 2 * c.numel() * 4)
    # per point: a weight sum and dsub products and sums; per centroid
    # element: a divide
    ops = r * n * (1 + 2 * dsub) + c.numel()
    b_ms, b_by = bound(nbytes, ops, torch.float32)
    cases.append(dict(r=r, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                      bound_by=b_by, nbytes=nbytes))
    print(f"{tag} B0 kmeans_update R={r} (N {n}, K {k_cent}, dsub {dsub}, "
          f"bf16 x, K6's ids): kernel {ms:.4f} ms plain (one-hot) "
          f"{plain_ms:.4f} ms bound {b_ms * 1e3:.3f} us ({b_by}, {nbytes} "
          f"B), {b_ms / ms:.4f} of the bound; library n/a")
    del x, w, a, c, got, want
  print(f"{tag} B0 kmeans_update: {checked} cases within "
        f"kmeans_update_tolerance ({share:.4f} of it at worst; R 512 and "
        f"128, bf16 and f32, K6's ids, empty clusters, zero weights, one "
        f"cluster, K > N, 16k bodies at dsub 2 and 4), frozen clusters "
        f"bit-equal, two calls bit-equal; "
        f"max abs err {err:.3e} at the timed shapes")
  serve = cases[0]
  return {"kmeans_update": dict(
      name="kmeans_update", route="cuda",
      source="src/repro_torch/csrc/kmeans_update.cu",
      replaces="src/repro/core/kmeans.py:52", max_abs_err=err,
      tolerance="kmeans_update.kmeans_update_tolerance",
      tolerance_share=share, bit_equal_calls=True, ms=serve["ms"],
      plain_ms=serve["plain_ms"], bound_ms=serve["bound_ms"],
      bound_by=serve["bound_by"], library_ms=None, cases=cases,
      long_cases=long_cases)}


def flash_kernel_phase(dev, tag) -> dict:
  """K7 against its plain version on the card: `ServeRun`'s prefill (batch
  4) and an engine admission (batch 1) at full width (Hq 32, Hkv 4, N 1024,
  d 64, bf16, causal), a ragged N (1000), a non-causal and an f32 case.
  Each is timed beside its bound, the plain version and SDPA (with GQA, on
  the same inputs; timed only, the port never calls it)."""
  from repro_torch.kernels import flash_attention as k7

  gen = torch.Generator(device=dev).manual_seed(4)
  sdpa = torch.nn.functional.scaled_dot_product_attention
  hq, hkv, d = 32, 4, 64
  scale = d ** -0.5
  cases = []
  for label, b, n, causal, dtype in (
      ("serve prefill", BATCH, PROMPT, True, torch.bfloat16),
      ("engine admission", 1, PROMPT, True, torch.bfloat16),
      ("ragged N", 1, 1000, True, torch.bfloat16),
      ("non-causal", BATCH, PROMPT, False, torch.bfloat16),
      ("f32", 1, PROMPT, True, torch.float32)):
    q = torch.randn(b, hq, n, d, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(b, hkv, n, d, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    got = k7.flash_attention(q, k, v, scale, causal)
    want = k7.flash_attention_plain(q, k, v, scale, causal)
    torch.cuda.synchronize()
    if got.dtype != dtype or not torch.isfinite(got).all():
      raise AssertionError(f"K7 {label}: bad output {got.dtype}")
    tol = k7.kernel_error_bound(q, k, v, scale, causal, want)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    # the largest share of its element's bound that any element uses
    share = float((diff / tol).max())
    tol_max, tol_med = float(tol.max()), float(tol.median())
    if not share <= 1.0:
      raise AssertionError(f"K7 {label}: error exceeds its bound ({share:.3f}"
                           f" of it; max abs err {err})")
    ms = cuda_time_ms(lambda: k7.flash_attention(q, k, v, scale, causal))
    plain_ms = cuda_time_ms(lambda: k7.flash_attention_plain(
        q, k, v, scale, causal), iters=10)
    library_ms = cuda_time_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                           scale=scale, enable_gqa=True))
    pairs = n * (n + 1) // 2 if causal else n * n
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    b_ms, b_by = bound(nbytes, 4 * b * hq * d * pairs, dtype)
    cases.append(dict(case=label, shape=[b, hq, hkv, n, d],
                      dtype=str(dtype).replace("torch.", ""), causal=causal,
                      max_abs_err=err, tolerance_share=share,
                      tolerance_max=tol_max, tolerance_median=tol_med, ms=ms,
                      plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                      library_ms=library_ms))
    print(f"{tag} K7 flash_attention {label} (B {b}, Hq {hq}, Hkv {hkv}, N "
          f"{n}, d {d}, {cases[-1]['dtype']}, causal {causal}): max_abs_err "
          f"{err:.3e}, {share:.4f} of its bound at worst (bound median "
          f"{tol_med:.3e}, max {tol_max:.3e}) kernel {ms:.4f} ms plain "
          f"{plain_ms:.4f} ms bound {b_ms * 1e3:.3f} us ({b_by}, {nbytes} B) "
          f"library (sdpa) {library_ms:.4f} ms; {ms / library_ms:.3f}x the "
          f"library, {b_ms / ms:.4f} of the bound")
    del q, k, v, got, want, tol, diff
  serve = cases[0]
  return {"flash_attention": dict(
      name="flash_attention", route="cuda",
      source="src/repro_torch/csrc/flash_attention.cu",
      replaces="src/repro/kernels/flash_attention.py:75",
      max_abs_err=max(c["max_abs_err"] for c in cases),
      tolerance="flash_attention.kernel_error_bound",
      tolerance_share=max(c["tolerance_share"] for c in cases),
      ms=serve["ms"],
      plain_ms=serve["plain_ms"], bound_ms=serve["bound_ms"],
      bound_by=serve["bound_by"], library_ms=serve["library_ms"],
      cases=cases)}


def launch_counters() -> dict:
  """Every kernel wrapper, by the name the kernels line uses."""
  from repro_torch.kernels import paged_flash_decode as pfd
  from repro_torch.kernels import pq_decode as pqd
  from repro_torch.kernels import flash_attention as k7
  from repro_torch.kernels import kmeans_assign as k6
  from repro_torch.kernels import kmeans_update as b0
  from repro_torch.kernels import packing
  return {"pq_decode_attention": pqd.pq_decode_attention,
          "flash_decode": pfd.flash_decode,
          "pq_decode_attention_paged": pqd.pq_decode_attention_paged,
          "paged_flash_decode": pfd.paged_flash_decode,
          "packed_paged_flash_decode": pfd.packed_paged_flash_decode,
          "kmeans_assign": k6.kmeans_assign,
          "kmeans_update": b0.kmeans_update,
          "flash_attention": k7.flash_attention,
          "unpack_u4": packing.unpack_u4_kernel}


def serve_phase(dev, tag) -> dict:
  """Full-width serve through ServeRun; counters prove the kernels ran:
  every layer of every prefill K7, every layer of every decode step its
  decode kernels (K1; K2; K8 twice, for K and V, then K2; the baselines
  none, but `pqcache` rebuilds its index through K6), every k-means
  assignment of every pq prefill K6.  Keeps the models the parity phase
  compares (the baselines' but snapkv's are dropped)."""
  from repro_torch.kernels import kmeans_update as b0
  from repro_torch.launch.serve import ServeRun

  counters = launch_counters()
  prefills = 3                 # warmup, timed, latency pass
  per_step = {"pq": {"pq_decode_attention": N_LAYERS},
              "exact": {"flash_decode": N_LAYERS},
              RAGGED_LABEL: {"flash_decode": N_LAYERS},
              "exact q4": {"flash_decode": N_LAYERS, "unpack_u4": 2 * N_LAYERS},
              "pqcache": {"kmeans_assign": K6_PER_PQCACHE_STEP,
                          "kmeans_update": B0_PER_PQCACHE_STEP}}
  runs = [("pq", "pq", "none", GEN, PROMPT),
          ("exact", "exact", "none", GEN, PROMPT),
          ("exact q4", "exact", CODEC, GEN, PROMPT),
          (RAGGED_LABEL, "exact", "none", BASELINE_GEN, RAGGED_PROMPT)]
  runs += [(name, name, "none", BASELINE_GEN, PROMPT) for name in BASELINES]
  models, launches = {}, {name: 0 for name in counters}
  for label, policy, codec, gen, prompt in runs:
    steps = 1 + 2 * gen        # warmup step, timed loop, latency pass
    run = ServeRun(arch=ARCH, reduced=False, batch=BATCH, prompt_len=prompt,
                   gen=gen, cache_policy=policy, kv_resident_codec=codec,
                   decode_kernel="auto", device=str(dev), seed=0)
    model = run.build()
    cfg = model.cfg
    for c in counters.values():
      c.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    plain_updates = [0]
    undo = _patched(b0, "kmeans_update_plain", _counted(plain_updates))
    try:
      res = run.run(model)
    finally:
      undo()
    peak = torch.cuda.max_memory_allocated(dev)
    if plain_updates[0]:
      raise AssertionError(f"{label}: {plain_updates[0]} k-means updates "
                           f"took the plain one-hot version under cuda")
    grew = {name: c.launches for name, c in counters.items()}
    want = {name: steps * per_step.get(label, {}).get(name, 0)
            for name in counters}
    want["flash_attention"] = prefills * cfg.n_layers
    if policy == "pq":
      want["kmeans_assign"] = prefills * K6_PER_PREFILL
      want["kmeans_update"] = prefills * B0_PER_PREFILL
    if grew != want:
      raise AssertionError(f"{label}: kernel launches {grew} != {want} "
                           f"({steps} decode steps x {cfg.n_layers} layers, "
                           f"{prefills} prefills)")
    toks = res["tokens"]
    if toks.shape != (BATCH, gen) or toks.min() < 0 or \
        toks.max() >= cfg.vocab_size:
      raise AssertionError(f"{label}: bad tokens {toks.shape}")
    decode = "torch" if policy in BASELINES else "cuda"
    if res["decode_kernel"] != decode:
      raise AssertionError(f"{label}: decode ran {res['decode_kernel']}")
    if codec != "none" and type(model.cache_policy).__name__ != \
        "PackedExactPolicy":
      raise AssertionError(f"{label}: served {model.cache_policy!r}")
    cache_bytes = sum(t.nbytes for t in model.init_cache(BATCH)[0]) * \
        cfg.n_layers
    policy_bytes = model.cache_policy.bytes(BATCH, cfg.n_kv_heads,
                                            cfg.head_dim)
    ran = ", ".join(f"{n} {grew[n]}" for n in counters if grew[n])
    print(f"{tag} serve {label}: prefill {res['prefill_s']:.4f} s decode "
          f"{res['tok_per_s']:.2f} tok/s step p50 "
          f"{res['decode_step_p50_ms']:.4f} ms p99 "
          f"{res['decode_step_p99_ms']:.4f} ms peak mem "
          f"{peak / 2**30:.3f} GiB, KV store {cache_bytes} B, kernel "
          f"launches {ran} ({steps} steps x {cfg.n_layers} layers, "
          f"{prefills} prefills)")
    print(f"{tag} serve {label} bytes(): {json.dumps(policy_bytes)}")
    print(f"{tag} serve {label} sample tokens: {toks[0].tolist()}")
    if policy not in BASELINES or policy == "snapkv":
      models[label] = (run, model)
    del model
    for name in counters:
      launches[name] += grew[name]
  return models, launches


def engine_phase(tag) -> dict:
  """Full-width continuous batching on the paged layout through the engine
  CLI's demo; counters prove every layer of every admission's prefill
  (warm-up request included) ran K7, every layer of every decode step ran
  K3 (pq), K4 (exact) or K5 (exact q4) and nothing else, and every pq
  admission ran K6 in every assignment.  `streamingllm` has no decode
  kernel: it takes the dense gather program, and its 512-token window must
  free the blocks that age out."""
  from repro_torch.launch import serve

  counters = launch_counters()
  kernel_of = {"pq": "pq_decode_attention_paged",
               "exact": "paged_flash_decode",
               "exact q4": "packed_paged_flash_decode",
               "pq preempt": "pq_decode_attention_paged",
               "streamingllm": None}
  launches = {name: 0 for name in counters}
  for label, policy, extra in (
      ("pq", "pq", []), ("exact", "exact", []),
      ("exact q4", "exact", ["--kv-resident-codec", CODEC]),
      ("pq preempt", "pq", ["--num-blocks", str(PREEMPT_BLOCKS)]),
      ("streamingllm", "streamingllm", [])):
    args = serve.make_parser().parse_args(
        ENGINE_ARGS + ["--cache-policy", policy] + extra)
    for c in counters.values():
      c.launches = 0
    res = serve.run_engine_demo(args)
    grew = {name: c.launches for name, c in counters.items()}
    steps = res["decode_steps"] + res["warmup_decode_steps"]
    kernel = kernel_of[label]
    want = {name: (steps * N_LAYERS if name == kernel else 0)
            for name in counters}
    prefills = res["admits"] + 1             # the warm-up request's too
    want["flash_attention"] = prefills * N_LAYERS
    if policy == "pq":
      want["kmeans_assign"] = prefills * K6_PER_PREFILL
      want["kmeans_update"] = prefills * B0_PER_PREFILL
    if grew != want:
      raise AssertionError(f"engine {label}: kernel launches {grew} != "
                           f"{want} ({steps} decode steps x {N_LAYERS} "
                           f"layers, {prefills} prefills)")
    path = ("torch", "dense-gather") if kernel is None else \
        ("cuda", "block-native")
    if (res["decode_kernel"], res["decode_path"]) != path:
      raise AssertionError(f"engine {label}: decode ran {res['decode_kernel']}"
                           f" {res['decode_path']}")
    reqs = res["requests"]
    if (res["finished"] != ENGINE_REQUESTS or len(reqs) != ENGINE_REQUESTS
        or any(len(r["tokens"]) != GEN for r in reqs)
        or any(not 0 <= t < 32000 for r in reqs for t in r["tokens"])):
      raise AssertionError(f"engine {label}: requests did not all finish "
                           f"with {GEN} valid tokens: {reqs}")
    if "preempt" in label and res["preempts"] < 1:
      raise AssertionError(f"engine {label}: {PREEMPT_BLOCKS} blocks did "
                           f"not force a preemption")
    if policy == "streamingllm" and res["blocks_reclaimed"] < 1:
      raise AssertionError("engine streamingllm: no block aged out of the "
                           "window")
    lat, by = res["decode_latency"], res["layout_bytes"]
    ran = ", ".join(f"{n} {grew[n]}" for n in counters if grew[n])
    print(f"{tag} engine {label}: {res['tok_per_s']:.2f} tok/s "
          f"({sum(len(r['tokens']) for r in reqs)} tokens in "
          f"{res['wall_s']:.4f} s), decode step p50 {lat['p50_ms']} ms p99 "
          f"{lat['p99_ms']} ms over {lat['steps']} steps, occupancy "
          f"{100 * res['occupancy']:.1f}%, preempts {res['preempts']}, peak "
          f"{by['peak_blocks']}/{by['num_blocks']} blocks of "
          f"{by['block_bytes']} B, blocks freed {res['blocks_reclaimed']}, "
          f"{res['decode_path']} decode, kernel launches {ran} ({steps} "
          f"steps x {N_LAYERS} layers, {prefills} prefills)")
    print(f"{tag} engine {label} decode traffic: "
          f"{json.dumps(res['decode_traffic'])}")
    for name in counters:
      launches[name] += grew[name]
  return launches


def _swapped(model, policy, fn):
  """fn() with `policy` as the model's cache policy (the dispatch it runs)."""
  keep = model.cache_policy
  model.cache_policy = policy
  try:
    return fn()
  finally:
    model.cache_policy = keep


def _logit_parity(lc, lt, label, tag) -> None:
  """cuda logits `lc` against torch logits `lt`: within LOGIT_ATOL, and the
  same argmax wherever the torch side's top-2 margin exceeds it."""
  lc, lt = lc.float(), lt.float()
  if not torch.isfinite(lc).all():
    raise AssertionError(f"{label}: non-finite logits")
  worst = float((lc - lt).abs().max())
  top2 = torch.topk(lt, 2, dim=-1).values
  decisive = (top2[..., 0] - top2[..., 1]) > LOGIT_ATOL
  if (torch.argmax(lc, -1) != torch.argmax(lt, -1))[decisive].any():
    raise AssertionError(f"{label}: decisive tokens differ")
  if not worst <= LOGIT_ATOL:
    raise AssertionError(f"{label}: cuda vs torch logits differ by {worst} "
                         f"> {LOGIT_ATOL}")
  print(f"{tag} parity {label}: cuda vs torch dispatch, max |dlogit| "
        f"{worst:.4f} (tol {LOGIT_ATOL}) over {lc.numel() // lc.shape[-1]} "
        f"rows, {int(decisive.sum())} decisive tokens equal")


def parity_phase(models, tag) -> None:
  """cuda vs torch dispatch: each policy's prefill logits (K7, and K6 for
  pq, against the plain versions); `Model.forward` logits of one sequence
  of PROMPT tokens; teacher-forced decode from one prefilled cache, and for
  pq and snapkv from each dispatch's own prefill."""
  for policy, (run, model) in models.items():
    cfg = model.cfg
    torch_policy = dataclasses.replace(
        cfg, decode_kernel="torch").make_cache_policy(model.context_len,
                                                      model.device)
    prompts = run.prompts(cfg.vocab_size).to(model.device)
    logits, cache = model.prefill(prompts)
    logits_t, cache_t = _swapped(model, torch_policy,
                                 lambda: model.prefill(prompts))
    _logit_parity(logits, logits_t, f"{policy} prefill (K7)", tag)
    if policy == "exact":
      seq = prompts[:1]
      fc, _ = model.forward(seq)
      ft, _ = _swapped(model, torch_policy, lambda: model.forward(seq))
      _logit_parity(fc, ft, f"Model.forward ({seq.shape[1]} tokens, K7)",
                    tag)
      del fc, ft
    tok = torch.argmax(logits_t, -1)
    variants = [] if policy == "snapkv" else [("", cache, cache)]
    if policy in ("pq", "snapkv"):
      note = "K6 and K7" if policy == "pq" else "K7"
      variants.append((f" (own prefills: {note} vs plain)", cache, cache_t))
    for note, cache_c, cache_tf in variants:
      _teacher_forced(model, model.cache_policy, torch_policy, tok, cache_c,
                      cache_tf, f"{policy}{note}", tag)


def _teacher_forced(model, cuda_policy, torch_policy, tok, cache_c, cache_t,
                    label, tag) -> None:
  """PARITY_STEPS decode steps of each dispatch on its cache, fed the torch
  dispatch's tokens; logits within LOGIT_ATOL, decisive tokens equal."""
  worst, checked = 0.0, 0
  try:
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
        raise AssertionError(f"{label}: non-finite logits")
      worst = max(worst, float((lc - lt).abs().max()))
      top2 = torch.topk(lt, 2, dim=-1).values
      decisive = (top2[:, 0] - top2[:, 1]) > LOGIT_ATOL
      if (torch.argmax(lc, -1) != torch.argmax(lt, -1))[decisive].any():
        raise AssertionError(f"{label}: tokens differ at step {i}")
      checked += int(decisive.sum())
      tok = torch.argmax(lt, -1)      # teacher-forced on the plain path
  finally:
    model.cache_policy = cuda_policy
  if not worst <= LOGIT_ATOL:
    raise AssertionError(f"{label}: cuda vs torch logits differ by "
                         f"{worst} > {LOGIT_ATOL}")
  print(f"{tag} parity {label}: cuda vs torch dispatch, "
        f"{PARITY_STEPS} steps, max |dlogit| {worst:.4f} (tol "
        f"{LOGIT_ATOL}), {checked} decisive tokens equal")


def paged_parity_phase(tag) -> dict:
  """cuda vs torch dispatch on the paged layout, from one admitted state
  per policy: the block-native program (K3/K4/K5 reading the pools in place)
  against the dense gather -> `Model.decode_step` -> scatter program on a
  copy of the same storage, teacher-forced on the plain path's tokens.
  Returns the engines (block-native, admitted) for the profile phase."""
  from repro_torch.launch import serve
  engines = {}
  for policy, extra in (("pq", []), ("exact", []),
                        ("exact q4", ["--kv-resident-codec", CODEC])):
    args = serve.make_parser().parse_args(
        ENGINE_ARGS + ["--cache-policy", policy.split()[0]] + extra)
    engine = serve.build_engine(args)
    layout, model = engine.layout, engine.model
    if not layout.block_native:
      raise AssertionError(f"paged {policy}: the layout is not block-native")
    rng = np.random.default_rng(1)
    for i in range(BATCH):
      engine.submit(rng.integers(0, model.cfg.vocab_size,
                                 size=PROMPT - 17 * i),
                    max_new_tokens=PARITY_STEPS + 2)
    engine._admit()
    cuda_policy = model.cache_policy
    torch_policy = dataclasses.replace(
        model.cfg, decode_kernel="torch").make_cache_policy(
            model.context_len, model.device)
    st_c = layout.storage
    st_t = [t.clone() for t in st_c]
    dev = model.device
    cur = torch.from_numpy(engine._cur).to(dev)
    worst, checked = 0.0, 0
    for i in range(PARITY_STEPS):
      engine._ensure_blocks()
      tables = torch.from_numpy(layout.manager.tables).to(dev)
      lengths = torch.from_numpy(engine._lengths).to(dev)
      lc, st_c = layout._decode_native_body(cur, st_c, tables, lengths)
      model.cache_policy = torch_policy
      try:
        lt, st_t = layout._decode_fused_body(cur, st_t, tables, lengths)
      finally:
        model.cache_policy = cuda_policy
      lc, lt = lc.float(), lt.float()
      if not torch.isfinite(lc).all():
        raise AssertionError(f"paged {policy}: non-finite logits")
      worst = max(worst, float((lc - lt).abs().max()))
      top2 = torch.topk(lt, 2, dim=-1).values
      decisive = (top2[:, 0] - top2[:, 1]) > LOGIT_ATOL
      if (torch.argmax(lc, -1) != torch.argmax(lt, -1))[decisive].any():
        raise AssertionError(f"paged {policy}: tokens differ at step {i}")
      checked += int(decisive.sum())
      cur = torch.argmax(lt, -1).to(torch.int32)
      engine._lengths += 1
    layout.storage = st_c
    engine._cur[:] = cur.cpu().numpy()
    if not worst <= LOGIT_ATOL:
      raise AssertionError(f"paged {policy}: block-native vs dense logits "
                           f"differ by {worst} > {LOGIT_ATOL}")
    print(f"{tag} paged parity {policy}: block-native (cuda) vs dense "
          f"gather (torch), {PARITY_STEPS} steps, max |dlogit| "
          f"{worst:.4f} (tol {LOGIT_ATOL}), {checked} decisive tokens equal")
    engines[policy] = engine
  return engines


def _profiled(step, steps: int):
  """(wall ms per step, [(device ms per step, launches per step, kernel)])
  of `steps` calls of `step` under `torch.profiler`."""
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(steps):
      step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
  rows = []
  for e in prof.key_averages():
    # kernel rows only: a CPU op's self device time repeats its kernels'
    if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0:
      rows.append((e.self_device_time_total / steps / 1e3,
                   e.count / steps, e.key))
  return wall_ms, rows


def profile_steps(step, tag, label, steps: int = 3) -> None:
  """Where a decode step's time goes: device busy share and top kernels.
  A trace that comes back without device events is taken once more."""
  step()          # warm
  torch.cuda.synchronize()
  wall_ms, rows = _profiled(step, steps)
  if not rows:
    wall_ms, rows = _profiled(step, steps)
  busy = sum(r[0] for r in rows)
  if not rows:
    print(f"{tag} profile {label}: the profiler saw no device time "
          f"(not measured)")
    return
  print(f"{tag} profile {label}: step {wall_ms:.3f} ms (profiled), "
        f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
        f"{sum(r[1] for r in rows):.0f} kernels per step")
  for ms, count, name in sorted(rows, reverse=True)[:8]:
    print(f"{tag}   {ms:.4f} ms/step  {count:.0f}x  {name[:90]}")


def _patched(module, name, wrap):
  """Swap module.name for wrap(module.name); returns the undo."""
  orig = getattr(module, name)
  setattr(module, name, wrap(orig))
  return lambda: setattr(module, name, orig)


def _counted(box):
  """fn -> fn whose calls add one to box[0]."""
  def wrap(fn):
    def counted(*a, **kw):
      box[0] += 1
      return fn(*a, **kw)
    return counted
  return wrap


def _sync_timed(acc, key):
  """fn -> fn whose calls add their synchronized wall seconds to acc[key]."""
  def wrap(fn):
    def timed(*a, **kw):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      out = fn(*a, **kw)
      torch.cuda.synchronize()
      acc[key] += time.perf_counter() - t0
      return out
    return timed
  return wrap


def profile_prefill(fn, tag, label) -> None:
  """Where a pq prefill's time goes.  One profiled call (`torch.profiler`,
  the k-means update marked with `record_function`): wall, device busy and
  its share, K6's and B0's device time, the update's device time, and the
  largest device entries.  Then one call with a synchronize around every K6 call and
  every `weighted_update`: the wall seconds each takes, and the rest."""
  from torch.profiler import ProfilerActivity, profile, record_function
  from repro_torch.core import kmeans
  from repro_torch.kernels import ops as kops

  def marked(f):
    def run(*a, **kw):
      with record_function("kmeans.weighted_update"):
        return f(*a, **kw)
    return run

  fn()                       # warm
  torch.cuda.synchronize()
  undo = _patched(kmeans, "weighted_update", marked)
  try:
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      fn()
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - t0) * 1e3
  finally:
    undo()
  rows, update = [], []
  for e in prof.key_averages():
    if e.key == "kmeans.weighted_update":
      # the range on the host (its kernels' device time) and its copy on
      # the device's timeline (not a kernel)
      update.append((e.count, e.cpu_time_total / 1e3,
                     e.device_time_total / 1e3))
    elif str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0:
      rows.append((e.self_device_time_total / 1e3, e.count, e.key))
  busy = sum(r[0] for r in rows)
  k6_ms = sum(r[0] for r in rows if "kmeans_assign_kernel" in r[2])
  b0_rows = [r for r in rows if "kmeans_update_kernel" in r[2]]
  b0_ms = sum(r[0] for r in b0_rows)
  upd = ", ".join(f"{c}x cpu {cpu:.3f} ms device {dv:.3f} ms"
                  for c, cpu, dv in update) or "not in the trace"
  print(f"{tag} profile {label}: wall {wall_ms:.3f} ms (profiled), device "
        f"busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
        f"{sum(r[1] for r in rows)} kernels; K6 device {k6_ms:.3f} ms; "
        f"B0 device {b0_ms:.3f} ms ({sum(r[1] for r in b0_rows)} launches); "
        f"kmeans.weighted_update {upd}")
  for ms, count, name in sorted(rows, reverse=True)[:10]:
    print(f"{tag}   {ms:.4f} ms  {count}x  {name[:90]}")

  spent = {"k6": 0.0, "update": 0.0}
  undo_u = _patched(kmeans, "weighted_update", _sync_timed(spent, "update"))
  undo_k = _patched(kops, "kmeans_assign", _sync_timed(spent, "k6"))
  try:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
  finally:
    undo_k()
    undo_u()
  print(f"{tag} profile {label}, synchronized wall: {total:.4f} s, of it "
        f"K6 calls {spent['k6']:.4f} s ({100 * spent['k6'] / total:.1f}%), "
        f"weighted_update {spent['update']:.4f} s "
        f"({100 * spent['update'] / total:.1f}%), the rest "
        f"{total - spent['k6'] - spent['update']:.4f} s")


def profile_phase(models, engines, tag) -> None:
  """A contiguous decode step (`Model.decode_step`) and a paged engine step
  (`layout.decode` + the engine's argmax and copy to the host); then the pq
  prefill of `ServeRun` (batch 4) and of one engine admission (batch 1,
  the engine's padded prompt)."""
  for policy, (run, model) in models.items():
    prompts = run.prompts(model.cfg.vocab_size).to(model.device)
    logits, cache = model.prefill(prompts)
    tok = torch.argmax(logits, -1)
    lengths = torch.full((BATCH,), PROMPT, dtype=torch.int32,
                         device=model.device)
    profile_steps(lambda: model.decode_step(tok, cache, lengths), tag,
                  f"{policy} contiguous")
    del cache
  for policy, engine in engines.items():
    layout = engine.layout
    profile_steps(lambda: torch.argmax(
        layout.decode(engine._cur, engine._lengths), -1).cpu(), tag,
        f"{policy} paged block-native")
  run, model = models["pq"]
  prompts = run.prompts(model.cfg.vocab_size).to(model.device)
  profile_prefill(lambda: model.prefill(prompts), tag,
                  f"pq ServeRun prefill (batch {BATCH}, prompt {PROMPT})")
  engine = engines["pq"]
  padded = torch.zeros((1, engine.prompt_capacity), dtype=torch.long,
                       device=engine.model.device)
  padded[0, :PROMPT] = prompts[0]
  plen = torch.tensor([PROMPT], dtype=torch.int32, device=engine.model.device)
  profile_prefill(lambda: engine.model.prefill(padded, plen), tag,
                  f"pq engine admission prefill (batch 1, prompt {PROMPT} "
                  f"padded to {engine.prompt_capacity})")


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
  kernels.update(paged_kernel_phase(dev, tag))
  kernels.update(packed_kernel_phase(dev, tag))
  kernels.update(kmeans_kernel_phase(dev, tag))
  kernels.update(kmeans_update_phase(dev, tag))
  kernels.update(flash_kernel_phase(dev, tag))
  print(f"{tag} kernel phase {time.monotonic() - t0:.2f} s")
  t0 = time.monotonic()
  models, serve_launches = serve_phase(dev, tag)
  print(f"{tag} serve phase {time.monotonic() - t0:.2f} s")
  t0 = time.monotonic()
  engine_launches = engine_phase(tag)
  print(f"{tag} engine phase {time.monotonic() - t0:.2f} s")
  # each kernel's launches on the paths that run it
  for name in kernels:
    kernels[name]["launches"] = serve_launches[name] + engine_launches[name]
  missing = [name for name in kernels if kernels[name]["launches"] == 0]
  if missing:
    raise AssertionError(f"kernels never launched on the main path: "
                         f"{missing}")
  t0 = time.monotonic()
  parity_phase(models, tag)
  engines = paged_parity_phase(tag)
  print(f"{tag} parity phase {time.monotonic() - t0:.2f} s")
  t0 = time.monotonic()
  profile_phase(models, engines, tag)
  print(f"{tag} profile phase {time.monotonic() - t0:.2f} s")

  print(json.dumps({"kernels": list(kernels.values())}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
