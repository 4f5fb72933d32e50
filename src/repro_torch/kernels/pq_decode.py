"""K1: PQ decode attention on compressed KV, over dense index buffers.

Port of `repro/kernels/pq_decode.py::pq_decode_attention_kernel` (the
contiguous-layout PQ body kernel).  `pq_decode_attention` is the wrapper: a
CPU tensor takes the plain version `pq_decode_attention_plain`; a CUDA
tensor launches the kernel in `csrc/pq_decode.cu` (its header says what
bounds it on the H100 and how its design answers that) or raises.  There is
no fallback from the kernel to the plain version.

Shapes, as the TPU kernel (`BH` = batch * kv heads):
  q (BH, g, d) bf16 or f32; key/value codebooks (BH, m, K, dsub) as stored
  (bf16 for the kernel); key/value indices (BH, N, m) uint8, int16 or int32,
  read in their storage width; length (BH,) int32 valid body tokens.
Returns (out (BH, g, d) f32 normalised, stats (BH, 2, g) f32 = [max, denom]).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core import pq_attention as pqa
from repro_torch.kernels import _build

NEG_INF = pqa.NEG_INF
SMEM_LIMIT = 232448            # bytes of shared memory one H100 block may use
_Q_CODES = {torch.bfloat16: 0, torch.float32: 1}
_IDX_CODES = {torch.uint8: 0, torch.int16: 1, torch.int32: 2}


def pq_decode_attention_plain(q, key_codebook, value_codebook, key_indices,
                              value_indices, length, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain PyTorch version: the inner-product table, the score lookup, a
  masked softmax and the reconstruct-values contraction, in f32."""
  n = key_indices.shape[1]
  mask = torch.arange(n, device=q.device)[None, :] < length[:, None].long()
  table = pqa.inner_product_table(q.float(), key_codebook)    # (BH, g, m, K)
  s = pqa.lookup_scores(table, key_indices) * scale            # (BH, g, N)
  s = torch.where(mask[:, None, :], s, torch.full_like(s, NEG_INF))
  mrow = pqa.max_or_neg_inf(s)
  p = torch.exp(s - mrow[..., None])
  p = torch.where(mask[:, None, :], p, torch.zeros_like(p))
  denom = torch.sum(p, dim=-1)
  vrec = pqa.reconstruct_values(value_indices, value_codebook)  # (BH, N, d)
  out = torch.matmul(p, vrec) / torch.clamp_min(denom, 1e-30)[..., None]
  return out, torch.stack([mrow, denom], dim=1)


def _lib() -> ctypes.CDLL:
  lib = _build.load("pq_decode")
  fn = lib.pq_decode_attention_launch
  fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
  fn.restype = ctypes.c_int
  lib.pq_decode_smem_bytes.argtypes = [ctypes.c_int] * 4
  lib.pq_decode_smem_bytes.restype = ctypes.c_size_t
  lib.pq_decode_max_g.restype = ctypes.c_int
  lib.pq_decode_max_outputs.restype = ctypes.c_int
  return lib


def _check(q, key_codebook, value_codebook, key_indices, value_indices,
           length) -> None:
  bh, g, d = q.shape
  if key_codebook.dim() != 4:
    raise ValueError(f"key_codebook must be (BH, m, K, dsub), got "
                     f"{tuple(key_codebook.shape)}")
  _, m, k_cent, dsub = key_codebook.shape
  n = key_indices.shape[1]
  want = {"key_codebook": (bh, m, k_cent, dsub),
          "value_codebook": (bh, m, k_cent, dsub),
          "key_indices": (bh, n, m), "value_indices": (bh, n, m),
          "length": (bh,)}
  got = {"key_codebook": key_codebook, "value_codebook": value_codebook,
         "key_indices": key_indices, "value_indices": value_indices,
         "length": length}
  for name, shape in want.items():
    if tuple(got[name].shape) != shape:
      raise ValueError(f"{name} shape {tuple(got[name].shape)} != {shape}")
  if m * dsub != d:
    raise ValueError(f"m*dsub = {m}*{dsub} != head dim {d}")
  if key_indices.dtype != value_indices.dtype:
    raise TypeError("key and value indices must share a dtype")


def pq_decode_attention(q, key_codebook, value_codebook, key_indices,
                        value_indices, length, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """K1 wrapper: plain version on CPU tensors, the CUDA kernel on CUDA
  tensors (or an error).  Counts its kernel launches in `.launches`."""
  _check(q, key_codebook, value_codebook, key_indices, value_indices, length)
  if q.device.type == "cpu":
    return pq_decode_attention_plain(q, key_codebook, value_codebook,
                                     key_indices, value_indices, length, scale)
  tensors = (q, key_codebook, value_codebook, key_indices, value_indices,
             length)
  if any(t.device != q.device for t in tensors):
    raise ValueError("all K1 inputs must be on one device")
  _build.require_sm90(q.device)
  if q.dtype not in _Q_CODES:
    raise TypeError(f"q must be bf16 or f32, got {q.dtype}")
  if key_codebook.dtype != torch.bfloat16 or \
      value_codebook.dtype != torch.bfloat16:
    raise TypeError("the kernel reads bf16 codebooks (their storage type)")
  if key_indices.dtype not in _IDX_CODES:
    raise TypeError(f"indices must be uint8, int16 or int32, got "
                    f"{key_indices.dtype}")
  if length.dtype != torch.int32:
    raise TypeError(f"length must be int32, got {length.dtype}")
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError("K1 inputs must be contiguous")
  bh, g, d = q.shape
  _, m, k_cent, _ = key_codebook.shape
  n = key_indices.shape[1]
  lib = _lib()
  if g > lib.pq_decode_max_g() or g * d > lib.pq_decode_max_outputs():
    raise ValueError(f"K1 takes g <= {lib.pq_decode_max_g()} and g*d <= "
                     f"{lib.pq_decode_max_outputs()}, got g={g}, d={d}")
  smem = lib.pq_decode_smem_bytes(g, d, m, k_cent)
  if smem > SMEM_LIMIT:
    raise ValueError(f"K1 needs {smem} B of shared memory for m={m}, "
                     f"K={k_cent}, d={d}, g={g}; a block has {SMEM_LIMIT}")
  out = torch.empty((bh, g, d), dtype=torch.float32, device=q.device)
  stats = torch.empty((bh, 2, g), dtype=torch.float32, device=q.device)
  err = lib.pq_decode_attention_launch(
      _Q_CODES[q.dtype], _IDX_CODES[key_indices.dtype], q.data_ptr(),
      key_codebook.data_ptr(), value_codebook.data_ptr(),
      key_indices.data_ptr(), value_indices.data_ptr(), length.data_ptr(),
      out.data_ptr(), stats.data_ptr(), bh, g, d, m, k_cent, n, float(scale),
      torch.cuda.current_stream(q.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"pq_decode_attention kernel launch failed: CUDA "
                       f"error {err}")
  pq_decode_attention.launches += 1
  return out, stats


pq_decode_attention.launches = 0
