"""Where K7's d = 64 time goes: the kernel against copies of itself with
parts taken out, on the card.

    python3 tools/k7_floors.py

Builds four libraries from `src/repro_torch/csrc/flash_attention.cu` into
`build/k7_floors/`: the kernel as it is, one whose softmax is a no-op
(P = S), one that loads no K/V tile after the first two, and one with
neither.  The three cut copies compute wrong outputs; they only bound what
the tensor-core pipeline, the softmax and the tile loads each cost.  Each is
timed (CUDA events, 50 launches after 5 warm-up) at `chip_smoke.py`'s K7
shapes (serve prefill B 4, engine admission B 1, non-causal B 4; Hq 32,
Hkv 4, N 1024, d 64, bf16) beside SDPA on the same inputs.  Needs one card
and nvcc; prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as k7  # noqa: E402

SRC = os.path.join(ROOT, "src", "repro_torch", "csrc", "flash_attention.cu")
OUT = os.path.join(ROOT, "build", "k7_floors")
NO_SOFTMAX = '''template <bool CAUSAL>
__device__ __forceinline__ void softmax_tile(float (&s)[kNB][4], Rows2& st, float& alpha0,
                                             float& alpha1, bool& resc, bool mask, int k0,
                                             int r0, int n, float sl2) {
  alpha0 = alpha1 = 1.f;
  resc = false;
  st.l0 += s[0][0];
  st.l1 += s[0][2];
}
'''
LOAD_LINE = "    if (kt + 2 < n_kt)\n      load("


def variants(src: str) -> dict:
  a = src.index("template <bool CAUSAL>\n__device__ __forceinline__ void "
                "softmax_tile(")
  b = src.index("\n}\n", a) + 3
  no_softmax = src[:a] + NO_SOFTMAX + src[b:]
  if src.count(LOAD_LINE) != 1:
    raise RuntimeError("the wgmma body's tile load was not found")
  cut = LOAD_LINE.replace("n_kt)", "n_kt && n < 0)")
  return {"kernel": src, "no softmax": no_softmax,
          "no loads": src.replace(LOAD_LINE, cut),
          "neither": no_softmax.replace(LOAD_LINE, cut)}


def build(srcs: dict) -> dict:
  os.makedirs(OUT, exist_ok=True)
  jobs = {}
  for name, text in srcs.items():
    stem = os.path.join(OUT, name.replace(" ", "_"))
    with open(stem + ".cu", "w") as fh:
      fh.write(text)
    cmd = [_build.nvcc(), *[x for x in _build.NVCC_FLAGS if x not in ("-Xptxas", "-v")],
           "-o", stem + ".so", stem + ".cu"]
    jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True), stem + ".so")
  libs = {}
  for name, (proc, so) in jobs.items():
    log, _ = proc.communicate()
    if proc.returncode:
      raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    libs[name] = so
  return libs


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  t0.record()
  for _ in range(iters):
    fn()
  t1.record()
  torch.cuda.synchronize()
  return t0.elapsed_time(t1) / iters


def main() -> int:
  if not torch.cuda.is_available():
    print("k7_floors: no CUDA device", file=sys.stderr)
    return 1
  print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       check=True).stdout.strip())
  with open(SRC) as fh:
    libs = build(variants(fh.read()))
  dev = torch.device("cuda", 0)
  gen = torch.Generator(device=dev).manual_seed(4)
  sdpa = torch.nn.functional.scaled_dot_product_attention
  cases = []
  for label, b, causal in (("serve prefill", 4, True), ("engine admission", 1, True),
                           ("non-causal", 4, False)):
    q = torch.randn(b, 32, 1024, 64, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, 4, 1024, 64, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    cases.append((label, q, k, v, causal))
  for name, so in libs.items():
    _build._LOADED["flash_attention"] = ctypes.CDLL(so)
    k7._LIB.clear()
    for label, q, k, v, causal in cases:
      ms = time_ms(lambda: k7.flash_attention(q, k, v, 0.125, causal))
      lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=causal, scale=0.125, enable_gqa=True))
      print(f"{name:10s} {label:16s} kernel {ms:.4f} ms  sdpa {lib_ms:.4f} ms")
  return 0


if __name__ == "__main__":
  sys.exit(main())
