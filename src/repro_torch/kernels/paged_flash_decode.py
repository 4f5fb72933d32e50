"""K2 and K4: GQA flash decode (the exact policy's decode kernels).

K2, `flash_decode`, ports `repro/kernels/paged_flash_decode.py::
flash_decode_kernel` (dense K/V, the contiguous layout); K4,
`paged_flash_decode`, ports `paged_flash_decode_kernel` (K/V pages read in
place from the paged layout's pools through block tables).  Each wrapper
takes its plain version (`*_plain`) for a CPU tensor, and for a CUDA tensor
launches its kernel (`csrc/flash_decode.cu`, `csrc/paged_flash_decode.cu`;
their headers say what bounds them on the H100 and how their design answers
that) or raises.  There is no fallback from a kernel to its plain version.
The packed variant (K5) is not ported yet (ROADMAP A7).

Shapes, as the TPU kernels: q (BH, g, d) in the cache dtype; K2 k, v
(BH, N, d) with length (BH,) int32 valid tokens; K4 pools (P+1, L, H, blk, d)
with tables (B, nb) int32, a Python-int layer and length (B,) int32, row bh
reading request bh // H and head bh % H.  Returns (BH, g, d) f32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import pq_attention as pqa
from repro_torch.kernels import _build
from repro_torch.kernels.pq_decode import check_paged

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


# ---------------------------------------------------------------------------
# K4: K/V pages read in place from the block pools
# ---------------------------------------------------------------------------

def paged_flash_decode_plain(q, k_pool, v_pool, tables, layer: int, length,
                             scale: float) -> torch.Tensor:
  """Plain PyTorch version of K4: gather the table-mapped pages of plane
  `layer` into dense (BH, nb * blk, d) K/V and run K2's plain version."""
  n_heads = k_pool.shape[2]

  def dense(pool):
    pages = pool[:, layer][tables.long()]          # (B, nb, H, blk, d)
    b, nb, h, blk, d = pages.shape
    return pages.permute(0, 2, 1, 3, 4).reshape(b * h, nb * blk, d)
  return flash_decode_plain(q, dense(k_pool), dense(v_pool),
                            length.repeat_interleave(n_heads), scale)


def _lib_paged() -> ctypes.CDLL:
  lib = _build.load("paged_flash_decode")
  fn = lib.paged_flash_decode_launch
  fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                 + [ctypes.c_float, ctypes.c_void_p])
  fn.restype = ctypes.c_int
  lib.paged_flash_decode_smem_bytes.argtypes = [ctypes.c_int] * 2
  lib.paged_flash_decode_smem_bytes.restype = ctypes.c_size_t
  lib.paged_flash_decode_max_outputs.restype = ctypes.c_int
  return lib


def paged_flash_decode(q, k_pool, v_pool, tables, layer: int, length,
                       scale: float) -> torch.Tensor:
  """K4 wrapper: plain version on CPU tensors, the CUDA kernel on CUDA
  tensors (or an error).  Counts its kernel launches in `.launches`."""
  bh, g, d = q.shape
  check_paged("K4", bh, (k_pool, v_pool), tables, layer, length)
  if k_pool.shape[4] != d:
    raise ValueError(f"pool rows {k_pool.shape[4]} != head dim {d}")
  if q.device.type == "cpu":
    return paged_flash_decode_plain(q, k_pool, v_pool, tables, layer, length,
                                    scale)
  tensors = (q, k_pool, v_pool, tables, length)
  if any(t.device != q.device for t in tensors):
    raise ValueError("all K4 inputs must be on one device")
  _build.require_sm90(q.device)
  if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype:
    raise TypeError(f"q and the pools must share bf16 or f32, got {q.dtype}, "
                    f"{k_pool.dtype}")
  if tables.dtype != torch.int32 or length.dtype != torch.int32:
    raise TypeError(f"tables and length must be int32, got {tables.dtype}, "
                    f"{length.dtype}")
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError("K4 inputs must be contiguous")
  lib = _lib_paged()
  if g * d > lib.paged_flash_decode_max_outputs():
    raise ValueError(f"K4 takes g*d <= {lib.paged_flash_decode_max_outputs()}"
                     f", got g={g}, d={d}")
  smem = lib.paged_flash_decode_smem_bytes(g, d)
  if smem > SMEM_LIMIT:
    raise ValueError(f"K4 needs {smem} B of shared memory; a block has "
                     f"{SMEM_LIMIT}")
  _, n_layers, n_heads, blk, _ = k_pool.shape
  out = torch.empty((bh, g, d), dtype=torch.float32, device=q.device)
  err = lib.paged_flash_decode_launch(
      _DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
      v_pool.data_ptr(), tables.data_ptr(), length.data_ptr(),
      out.data_ptr(), bh, g, d, n_heads, blk, tables.shape[1], n_layers,
      int(layer), float(scale),
      torch.cuda.current_stream(q.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"paged_flash_decode kernel launch failed: CUDA error "
                       f"{err}")
  paged_flash_decode.launches += 1
  return out


paged_flash_decode.launches = 0
