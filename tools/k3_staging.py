"""Where K3's time goes: the split kernel with both bf16 codebooks staged
in shared memory against one that stages only the key codebook and reads
value centroids from global memory (L2) in the rebuild, each at 256 and
512 threads a block.

    python3 tools/k3_staging.py

Builds four libraries from `src/repro_torch/csrc/pq_decode_paged.cu` into
`build/k3_staging/`, each from a copy of the split body with its text
patched: both codebooks staged (the kernel as it is, ~182 KiB of shared
memory at m=32, K=512, dsub=2 and 512 threads: one block per SM) or only
the key codebook, the rebuild reading value centroids from global memory
(~118 KiB), times `kThreads` 256 or 512.
Each runs split and merge (one C call) at `chip_smoke.py`'s K3 shape (the
engine's first batch: BH 16, g 8, d 64, m 32, K 512, int16 index pools,
layer 21 of 22, blk 16, 64 blocks per row, body lengths 984, 967, 950, 933)
on the split the wrapper's rule gives for one block per SM (S = SMs // BH)
and for two (S = 2 SMs // BH), is checked against the plain version (within
1e-4), timed back to back (CUDA events, 50 calls after 5 warm-up) and
profiled (`torch.profiler`, 20 calls: the split and the merge kernel's
device time per call).  Needs one card and nvcc; prints the card's name and
power limit first.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import cuda_time_ms, device_ms, smi_line  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import pq_decode as pqd  # noqa: E402

OUT = os.path.join(ROOT, "build", "k3_staging")
HEADERS = ("pq_decode_split_body.cuh", "pq_decode_body.cuh")
THREADS = "constexpr int kThreads = 512;"
# The key codebook alone in shared memory; the rebuild reads the value
# centroids of row bh from global memory.
KEYS_ONLY = (
    ("  b += 2 * (size_t)cb_slot(m, k, dsub) * 2;  // codebooks\n",
     "  b += (size_t)cb_slot(m, k, dsub) * 2;  // the key codebook\n"),
    ("  __nv_bfloat16* vcb_s = kcb_s + slot;\n"
     "  const IT** krow_s = reinterpret_cast<const IT**>(vcb_s + slot);\n",
     "  const __nv_bfloat16* vcb_s = vcb + (size_t)bh * cb_elems;\n"
     "  const IT** krow_s = reinterpret_cast<const IT**>(kcb_s + slot);\n"),
    ("  stage(vcb_s, vcb_g, cb_elems);\n", ""),
)


def patch(text: str, pairs) -> str:
  """text with each (old, new) replaced; each old must occur once."""
  for old, new in pairs:
    if text.count(old) != 1:
      raise RuntimeError(f"{old!r} not found once in {HEADERS[0]}")
    text = text.replace(old, new)
  return text


def build() -> dict:
  """The four variants, compiled in parallel; name -> loaded library."""
  body = open(_build.CSRC / HEADERS[0]).read()
  jobs = {}
  for staged in ("both", "keys"):
    for threads in (256, 512):
      name = f"{staged} staged, {threads} threads"
      text = patch(body, [(THREADS, THREADS.replace("512", str(threads)))])
      if staged == "keys":
        text = patch(text, KEYS_ONLY)
      d = os.path.join(OUT, f"{staged}_{threads}")
      os.makedirs(d, exist_ok=True)
      shutil.copy(_build.CSRC / "pq_decode_paged.cu", d)
      shutil.copy(_build.CSRC / HEADERS[1], d)
      with open(os.path.join(d, HEADERS[0]), "w") as fh:
        fh.write(text)
      so = os.path.join(d, "libk3.so")
      cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(d, "pq_decode_paged.cu")]
      jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), so)
  libs = {}
  for name, (proc, so) in jobs.items():
    log, _ = proc.communicate()
    if proc.returncode:
      raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    print(f"{name}: at most {max(regs)} registers a thread, "
          f"{log.count('spill stores') - log.count(' 0 bytes spill stores')} "
          f"kernels that spill")
    libs[name] = pqd.bind_paged(ctypes.CDLL(so))
  return libs


def main() -> int:
  if not torch.cuda.is_available():
    print("k3_staging: no CUDA device", file=sys.stderr)
    return 1
  print(smi_line())
  dev = torch.device("cuda", 0)
  sms = _build.sm_count(dev)
  libs = build()
  gen = torch.Generator(device=dev).manual_seed(1)
  b, h, g, d, m, k, blk, nb, n_layers = 4, 4, 8, 64, 32, 512, 16, 64, 22
  bh, layer, scale = b * h, n_layers - 1, d ** -0.5
  pool_blocks = 4 * nb
  q = torch.randn(bh, g, d, generator=gen, device=dev).to(torch.bfloat16)
  kcb, vcb = (torch.randn(bh, m, k, d // m, generator=gen, device=dev
                          ).to(torch.bfloat16) for _ in range(2))
  shape = (pool_blocks + 1, n_layers, h, blk, m)
  kp, vp = (torch.randint(0, k, shape, generator=gen, device=dev
                          ).to(torch.int16) for _ in range(2))
  body = torch.tensor([1024 - 17 * i - 40 for i in range(b)],
                      dtype=torch.int32, device=dev)
  perm = torch.randperm(pool_blocks, generator=gen, device=dev)[:b * nb]
  tables = perm.reshape(b, nb).to(torch.int32)
  want, want_st = pqd.pq_decode_attention_paged_plain(
      q, kcb, vcb, kp, vp, tables, layer, body, scale)
  stream = torch.cuda.current_stream(dev).cuda_stream
  for name, lib in libs.items():
    smem = lib.pq_decode_paged_smem_bytes(g, d, m, k)
    for per_sm in (1, 2):
      n_split, chunk = pqd.pq_decode_paged_split(bh, nb * blk, per_sm * sms)
      scratch = torch.empty(bh * n_split * g * (d + 2), device=dev)
      out = torch.empty(bh, g, d, device=dev)
      st = torch.empty(bh, 2, g, device=dev)

      def call():
        err = lib.pq_decode_paged_launch(
            0, 1, q.data_ptr(), kcb.data_ptr(), vcb.data_ptr(), kp.data_ptr(),
            vp.data_ptr(), tables.data_ptr(), body.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), st.data_ptr(), bh, g, d, m, k,
            h, blk, nb, n_layers, layer, n_split, chunk, scale, stream)
        if err:
          raise RuntimeError(f"{name}: CUDA error {err}")
      call()
      torch.cuda.synchronize()
      err = max(float((out - want).abs().max()),
                float((st - want_st).abs().max()))
      if not err <= 1e-4:
        raise AssertionError(f"{name}: max abs err {err} > 1e-4")
      ms = cuda_time_ms(call)
      dev_us = {key: 1e3 * device_ms(call, (f"pq_decode_{key}_kernel",))
                for key in ("split", "merge")}
      print(f"K3 {name} ({smem} B of shared memory), split S {n_split} x "
            f"{chunk} tokens ({bh * n_split} blocks for {per_sm} per SM): "
            f"{ms:.4f} ms a call back to back; device {dev_us['split']:.2f} "
            f"us split + {dev_us['merge']:.2f} us merge; max abs err "
            f"{err:.3e}")
  return 0


if __name__ == "__main__":
  sys.exit(main())
