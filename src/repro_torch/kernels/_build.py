"""Build the CUDA sources under `repro_torch/csrc/` and load them.

Each `csrc/<name>.cu` compiles with `nvcc` into a shared library with a
plain C interface (`-gencode arch=compute_90a,code=sm_90a`), loaded through
`ctypes`.  Libraries land in `build/repro_torch/` at the repository root,
named by a hash of the source, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source or header rebuilds and an unchanged one is
reused.  Nothing builds at import time: a wrapper asks for
its library when it first launches, and `build_all` compiles every source in
parallel (one `nvcc` each, all started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("pq_decode", "flash_decode", "pq_decode_paged",
           "paged_flash_decode", "packed_paged_flash_decode",
           "kmeans_assign", "kmeans_update", "unpack_u4", "flash_attention")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
  for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError(
      "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the CUDA "
      "decode kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
  src = (CSRC / f"{name}.cu").read_bytes()
  src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
  digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
  return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
  """Start one nvcc; returns (process, tmp path, final path) or None when the
  library is already built."""
  out = library_path(name)
  if out.exists():
    return None
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_suffix(f".{os.getpid()}.tmp")
  proc = subprocess.Popen(
      [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  return proc, tmp, out


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
  """Compile every named source in parallel; returns the compiler's output
  (registers, shared memory, spills from `-Xptxas -v`) per source that was
  built.  Raises if any build fails."""
  jobs = {n: _start(n) for n in names}
  logs, failed = {}, []
  for name, job in jobs.items():
    if job is None:
      continue
    proc, tmp, out = job
    log, _ = proc.communicate()
    logs[name] = log
    if proc.returncode != 0:
      failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
      tmp.unlink(missing_ok=True)
    else:
      os.replace(tmp, out)
  if failed:
    raise RuntimeError("nvcc failed for " + "\n".join(failed))
  return logs


def load(name: str) -> ctypes.CDLL:
  """The loaded library for `csrc/<name>.cu`, building it if needed."""
  lib = _LOADED.get(name)
  if lib is None:
    build_all([name])
    lib = ctypes.CDLL(str(library_path(name)))
    _LOADED[name] = lib
  return lib


_CHECKED_DEVICES = set()
_SM_COUNTS: Dict[str, int] = {}

H100_SMS = 132                 # the default the split pickers assume


def sm_count(device) -> int:
  """The device's SM count (queried once per device)."""
  key = str(device)
  if key not in _SM_COUNTS:
    import torch
    _SM_COUNTS[key] = torch.cuda.get_device_properties(
        device).multi_processor_count
  return _SM_COUNTS[key]


def require_sm90(device) -> None:
  """Refuse a card the kernels were not built for (checked once per device)."""
  from repro_torch.core import decode_dispatch
  key = str(device)
  if key not in _CHECKED_DEVICES:
    decode_dispatch.require_sm90(device)
    _CHECKED_DEVICES.add(key)
