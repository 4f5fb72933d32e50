"""K1 and K3: PQ decode attention on compressed KV.

K1, `pq_decode_attention`, ports `repro/kernels/pq_decode.py::
pq_decode_attention_kernel` (dense index buffers, the contiguous layout);
K3, `pq_decode_attention_paged`, ports `pq_decode_attention_paged_kernel`
(index pages read in place from the paged layout's pool through block
tables).  Each wrapper takes its plain version (`*_plain`) for a CPU tensor,
and for a CUDA tensor launches its kernel (`csrc/pq_decode.cu`,
`csrc/pq_decode_paged.cu`; their headers say what bounds them on the H100
and how their design answers that) or raises.  There is no fallback from a
kernel to its plain version.

Shapes, as the TPU kernels (`BH` = batch * kv heads):
  q (BH, g, d) bf16 or f32; key/value codebooks (BH, m, K, dsub) as stored
  (bf16 for the kernels); indices read in their storage width (uint8, int16
  or int32): K1 (BH, N, m) with length (BH,) int32 valid body tokens; K3
  pools (P+1, L, H, blk, m) with tables (B, nb) int32, a Python-int layer and
  length (B,) int32, row bh reading request bh // H and head bh % H.
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


# ---------------------------------------------------------------------------
# K3: index pages read in place from the block pool
# ---------------------------------------------------------------------------

def pq_decode_attention_paged_plain(q, key_codebook, value_codebook,
                                    key_index_pool, value_index_pool, tables,
                                    layer: int, length, scale: float
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain PyTorch version of K3: gather the table-mapped pages of plane
  `layer` into a dense (BH, nb * blk, m) view and run K1's plain version."""
  n_heads = key_index_pool.shape[2]

  def dense(pool):
    pages = pool[:, layer][tables.long()]          # (B, nb, H, blk, m)
    b, nb, h, blk, m = pages.shape
    return pages.permute(0, 2, 1, 3, 4).reshape(b * h, nb * blk, m)
  return pq_decode_attention_plain(
      q, key_codebook, value_codebook, dense(key_index_pool),
      dense(value_index_pool), length.repeat_interleave(n_heads), scale)


def _lib_paged() -> ctypes.CDLL:
  lib = _build.load("pq_decode_paged")
  fn = lib.pq_decode_paged_launch
  fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
  fn.restype = ctypes.c_int
  lib.pq_decode_paged_smem_bytes.argtypes = [ctypes.c_int] * 4
  lib.pq_decode_paged_smem_bytes.restype = ctypes.c_size_t
  lib.pq_decode_paged_max_g.restype = ctypes.c_int
  lib.pq_decode_paged_max_outputs.restype = ctypes.c_int
  return lib


def check_paged(name: str, bh: int, pools, tables, layer, length) -> None:
  """Shape rules shared by the block-table-native wrappers (K3, K4):
  pools (P+1, L, H, blk, w) of one shape, tables (B, nb) with B * H = BH,
  length (B,), a Python-int layer in [0, L)."""
  if isinstance(layer, torch.Tensor):
    raise TypeError(f"{name}: layer must be a Python int, not a tensor "
                    f"(reading a device scalar would sync the host)")
  if pools[0].dim() != 5 or any(p.shape != pools[0].shape for p in pools):
    raise ValueError(f"{name}: pools must share one (P+1, L, H, blk, w) "
                     f"shape, got {[tuple(p.shape) for p in pools]}")
  _, n_layers, n_heads, _, _ = pools[0].shape
  if tables.dim() != 2 or tables.shape[0] * n_heads != bh:
    raise ValueError(f"{name}: tables {tuple(tables.shape)} must be (B, nb) "
                     f"with B * {n_heads} heads = {bh} rows")
  if tuple(length.shape) != (tables.shape[0],):
    raise ValueError(f"{name}: length {tuple(length.shape)} != "
                     f"({tables.shape[0]},)")
  if not 0 <= int(layer) < n_layers:
    raise ValueError(f"{name}: layer {layer} not in [0, {n_layers})")
  if pools[0].dtype != pools[-1].dtype:
    raise TypeError(f"{name}: pools must share a dtype")


def pq_decode_attention_paged(q, key_codebook, value_codebook,
                              key_index_pool, value_index_pool, tables,
                              layer: int, length, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """K3 wrapper: plain version on CPU tensors, the CUDA kernel on CUDA
  tensors (or an error).  Counts its kernel launches in `.launches`."""
  bh, g, d = q.shape
  pools = (key_index_pool, value_index_pool)
  check_paged("K3", bh, pools, tables, layer, length)
  _, _, n_heads, blk, m = key_index_pool.shape
  if key_codebook.dim() != 4 or key_codebook.shape[:2] != (bh, m) or \
      value_codebook.shape != key_codebook.shape:
    raise ValueError(f"codebooks {tuple(key_codebook.shape)}, "
                     f"{tuple(value_codebook.shape)} must be (BH={bh}, m={m}, "
                     f"K, dsub)")
  k_cent, dsub = key_codebook.shape[2:]
  if m * dsub != d:
    raise ValueError(f"m*dsub = {m}*{dsub} != head dim {d}")
  if q.device.type == "cpu":
    return pq_decode_attention_paged_plain(
        q, key_codebook, value_codebook, key_index_pool, value_index_pool,
        tables, layer, length, scale)
  tensors = (q, key_codebook, value_codebook, key_index_pool,
             value_index_pool, tables, length)
  if any(t.device != q.device for t in tensors):
    raise ValueError("all K3 inputs must be on one device")
  _build.require_sm90(q.device)
  if q.dtype not in _Q_CODES:
    raise TypeError(f"q must be bf16 or f32, got {q.dtype}")
  if key_codebook.dtype != torch.bfloat16 or \
      value_codebook.dtype != torch.bfloat16:
    raise TypeError("the kernel reads bf16 codebooks (their storage type)")
  if key_index_pool.dtype not in _IDX_CODES:
    raise TypeError(f"index pools must be uint8, int16 or int32, got "
                    f"{key_index_pool.dtype}")
  if tables.dtype != torch.int32 or length.dtype != torch.int32:
    raise TypeError(f"tables and length must be int32, got {tables.dtype}, "
                    f"{length.dtype}")
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError("K3 inputs must be contiguous")
  lib = _lib_paged()
  if g > lib.pq_decode_paged_max_g() or \
      g * d > lib.pq_decode_paged_max_outputs():
    raise ValueError(f"K3 takes g <= {lib.pq_decode_paged_max_g()} and g*d "
                     f"<= {lib.pq_decode_paged_max_outputs()}, got g={g}, "
                     f"d={d}")
  smem = lib.pq_decode_paged_smem_bytes(g, d, m, k_cent)
  if smem > SMEM_LIMIT:
    raise ValueError(f"K3 needs {smem} B of shared memory for m={m}, "
                     f"K={k_cent}, d={d}, g={g}; a block has {SMEM_LIMIT}")
  out = torch.empty((bh, g, d), dtype=torch.float32, device=q.device)
  stats = torch.empty((bh, 2, g), dtype=torch.float32, device=q.device)
  err = lib.pq_decode_paged_launch(
      _Q_CODES[q.dtype], _IDX_CODES[key_index_pool.dtype], q.data_ptr(),
      key_codebook.data_ptr(), value_codebook.data_ptr(),
      key_index_pool.data_ptr(), value_index_pool.data_ptr(),
      tables.data_ptr(), length.data_ptr(), out.data_ptr(), stats.data_ptr(),
      bh, g, d, m, k_cent, n_heads, blk, tables.shape[1],
      key_index_pool.shape[1], int(layer), float(scale),
      torch.cuda.current_stream(q.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"pq_decode_attention_paged kernel launch failed: "
                       f"CUDA error {err}")
  pq_decode_attention_paged.launches += 1
  return out, stats


pq_decode_attention_paged.launches = 0
