"""K2: GQA flash decode over dense K/V (the exact policy's decode kernel).

Port of `repro/kernels/paged_flash_decode.py::flash_decode_kernel` (the
contiguous-layout exact kernel).  `flash_decode` is the wrapper: a CPU
tensor takes the plain version `flash_decode_plain`; a CUDA tensor launches
the kernel in `csrc/flash_decode.cu` (its header says what bounds it on the
H100 and how its design answers that) or raises.  There is no fallback from
the kernel to the plain version.  The paged variants (K4, K5) are not
ported yet.

Shapes, as the TPU kernel: q (BH, g, d); k, v (BH, N, d) in the cache dtype
(q shares it); length (BH,) int32 valid tokens.  Returns (BH, g, d) f32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import pq_attention as pqa
from repro_torch.kernels import _build

SMEM_LIMIT = 232448            # bytes of shared memory one H100 block may use
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def flash_decode_plain(q, k, v, length, scale: float) -> torch.Tensor:
  """Plain PyTorch version: masked softmax attention in f32 (zero output
  for a row with length 0, as the kernel)."""
  n = k.shape[1]
  mask = torch.arange(n, device=q.device)[None, :] < length[:, None].long()
  out, _, _ = pqa.segment_attention_stats(q, k, v, mask, scale)
  return out


def _lib() -> ctypes.CDLL:
  lib = _build.load("flash_decode")
  fn = lib.flash_decode_launch
  fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                 + [ctypes.c_float, ctypes.c_void_p])
  fn.restype = ctypes.c_int
  lib.flash_decode_smem_bytes.argtypes = [ctypes.c_int] * 2
  lib.flash_decode_smem_bytes.restype = ctypes.c_size_t
  lib.flash_decode_max_outputs.restype = ctypes.c_int
  return lib


def flash_decode(q, k, v, length, scale: float) -> torch.Tensor:
  """K2 wrapper: plain version on CPU tensors, the CUDA kernel on CUDA
  tensors (or an error).  Counts its kernel launches in `.launches`."""
  bh, g, d = q.shape
  n = k.shape[1]
  for name, t, shape in (("k", k, (bh, n, d)), ("v", v, (bh, n, d)),
                         ("length", length, (bh,))):
    if tuple(t.shape) != shape:
      raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
  if q.device.type == "cpu":
    return flash_decode_plain(q, k, v, length, scale)
  tensors = (q, k, v, length)
  if any(t.device != q.device for t in tensors):
    raise ValueError("all K2 inputs must be on one device")
  _build.require_sm90(q.device)
  if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
    raise TypeError(f"q, k, v must share bf16 or f32, got {q.dtype}, "
                    f"{k.dtype}, {v.dtype}")
  if length.dtype != torch.int32:
    raise TypeError(f"length must be int32, got {length.dtype}")
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError("K2 inputs must be contiguous")
  lib = _lib()
  if g * d > lib.flash_decode_max_outputs():
    raise ValueError(f"K2 takes g*d <= {lib.flash_decode_max_outputs()}, "
                     f"got g={g}, d={d}")
  smem = lib.flash_decode_smem_bytes(g, d)
  if smem > SMEM_LIMIT:
    raise ValueError(f"K2 needs {smem} B of shared memory; a block has "
                     f"{SMEM_LIMIT}")
  out = torch.empty((bh, g, d), dtype=torch.float32, device=q.device)
  err = lib.flash_decode_launch(
      _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
      length.data_ptr(), out.data_ptr(), bh, g, d, n, float(scale),
      torch.cuda.current_stream(q.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {err}")
  flash_decode.launches += 1
  return out


flash_decode.launches = 0
