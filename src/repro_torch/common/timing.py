"""Small reusable timers for the serve loop.

`Stopwatch` wraps a block; `wait_for` synchronises the tensor's CUDA device
so asynchronously launched kernels are counted.
"""
from __future__ import annotations

import time

import numpy as np
import torch


class Stopwatch:
  """Context manager measuring wall time of a block.

      with Stopwatch() as sw:
        out = fn(x)
        sw.wait_for(out)          # wait for queued device work before stopping
      print(sw.seconds)
  """

  def __init__(self):
    self.seconds = 0.0
    self._t0 = 0.0

  def __enter__(self) -> "Stopwatch":
    self._t0 = time.monotonic()
    return self

  def wait_for(self, tensor: torch.Tensor) -> None:
    if tensor.device.type == "cuda":
      torch.cuda.synchronize(tensor.device)

  def __exit__(self, *exc) -> bool:
    self.seconds = time.monotonic() - self._t0
    return False


def latency_percentiles_ms(step_seconds) -> dict:
  """Per-step latency percentiles over raw wall-clock samples (seconds),
  defined as in the reference serve loop."""
  samples = list(step_seconds)
  if not samples:
    return dict(steps=0, p50_ms=None, p99_ms=None, mean_ms=None)
  a = np.asarray(samples, np.float64) * 1e3
  return dict(steps=int(a.size),
              p50_ms=round(float(np.percentile(a, 50)), 4),
              p99_ms=round(float(np.percentile(a, 99)), 4),
              mean_ms=round(float(a.mean()), 4))
