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

K3 runs in two steps on the card: a split kernel over (row, chunk of the
sequence) writes unnormalised partials and a merge kernel combines them in
chunk order (`pq_decode_paged_split` picks the chunks from the capacity;
the steps' plain versions are `pq_decode_paged_partials_plain` and
`pq_decode_paged_merge_plain`; `pq_decode_attention_paged_plain` stays the
one-pass oracle).

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
PQ_TILE = 64                   # K3's token tile; its chunks are whole tiles
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

def dense_pages(pool, tables, layer: int) -> torch.Tensor:
  """The table-mapped pages of plane `layer` of a pool (P+1, L, H, blk, w)
  as dense (B * H, nb * blk, w) rows (the plain versions of the
  block-table-native kernels read through it)."""
  pages = pool[:, layer][tables.long()]            # (B, nb, H, blk, w)
  b, nb, h, blk, w = pages.shape
  return pages.permute(0, 2, 1, 3, 4).reshape(b * h, nb * blk, w)


def pq_decode_attention_paged_plain(q, key_codebook, value_codebook,
                                    key_index_pool, value_index_pool, tables,
                                    layer: int, length, scale: float
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain PyTorch version of K3: gather the table-mapped pages of plane
  `layer` into a dense (BH, nb * blk, m) view and run K1's plain version."""
  n_heads = key_index_pool.shape[2]
  return pq_decode_attention_plain(
      q, key_codebook, value_codebook,
      dense_pages(key_index_pool, tables, layer),
      dense_pages(value_index_pool, tables, layer),
      length.repeat_interleave(n_heads), scale)


def pq_decode_paged_split(bh: int, n: int, sms: int = _build.H100_SMS
                          ) -> Tuple[int, int]:
  """(S, chunk): K3's split of a capacity of n body tokens over S blocks per
  row.

  From the capacity and the SM count alone (never the device `length`, which
  would cost a host sync).  A split block holds both codebooks in shared
  memory and so fits once per SM: S = sms // bh keeps bh * S within one
  wave, capped at the number of 64-token tiles (at least 1); chunk = whole
  tiles, 64 ceil(tiles / S); S is then recounted so every chunk starts below
  n.  Chunk s covers tokens [s chunk, min((s + 1) chunk, n)).
  """
  tiles = max(1, -(-n // PQ_TILE))
  s = max(1, min(sms // max(bh, 1), tiles))
  chunk = PQ_TILE * -(-tiles // s)
  return -(-max(n, 1) // chunk), chunk


def pq_decode_paged_partials_plain(q, key_codebook, value_codebook,
                                   key_index_pool, value_index_pool, tables,
                                   layer: int, length, scale: float,
                                   n_split: int, chunk: int):
  """Plain version of K3's first step: each chunk's unnormalised partial.

  Returns acc (BH, S, g, d) = sum_t e^(s_t - m) v_t, and stats (BH, S, 2,
  g) = (m, sum_t e^(s_t - m)) over the chunk's tokens below the row's
  length, in f32; a chunk with no such token gives (0, NEG_INF, 0).
  """
  n_heads = key_index_pool.shape[2]
  kidx = dense_pages(key_index_pool, tables, layer)
  vidx = dense_pages(value_index_pool, tables, layer)
  n = kidx.shape[1]
  ln = length.repeat_interleave(n_heads).long()
  table = pqa.inner_product_table(q.float(), key_codebook)    # (BH, g, m, K)
  accs, stats = [], []
  for s in range(n_split):
    t0, t1 = s * chunk, min((s + 1) * chunk, n)
    mask = (torch.arange(t0, t1, device=q.device)[None, :]
            < ln[:, None])[:, None, :]                         # (BH, 1, c)
    sc = pqa.lookup_scores(table, kidx[:, t0:t1]) * scale      # (BH, g, c)
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    m = pqa.max_or_neg_inf(sc)
    p = torch.where(mask, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
    vrec = pqa.reconstruct_values(vidx[:, t0:t1], value_codebook)
    accs.append(torch.matmul(p, vrec))
    stats.append(torch.stack([m, p.sum(-1)], dim=1))
  return torch.stack(accs, dim=1), torch.stack(stats, dim=1)


def pq_decode_paged_merge_plain(acc, stats) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
  """Plain version of K3's second step: the flash-decoding combine of the
  partials, (BH, S, g, d) and (BH, S, 2, g) -> (out (BH, g, d) normalised,
  stats (BH, 2, g) = [max, denom]) in K3's contract; a row whose partials
  are all empty gives out 0, max NEG_INF, denom 0."""
  m, l = stats[:, :, 0], stats[:, :, 1]
  top = torch.amax(m, dim=1)                                   # (BH, g)
  w = torch.exp(m - top[:, None])
  num = (w[..., None] * acc).sum(dim=1)
  den = (w * l).sum(dim=1)
  return num / den.clamp_min(1e-30)[..., None], torch.stack([top, den], 1)


_LIB_PAGED = {}


def bind_paged(lib: ctypes.CDLL) -> ctypes.CDLL:
  """Set the argument types of K3's C functions on a loaded library."""
  fn = lib.pq_decode_paged_launch
  fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                 + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p])
  fn.restype = ctypes.c_int
  fn = lib.pq_decode_paged_split_launch
  fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                 + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p])
  fn.restype = ctypes.c_int
  fn = lib.pq_decode_paged_merge_launch
  fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
  fn.restype = ctypes.c_int
  lib.pq_decode_paged_smem_bytes.argtypes = [ctypes.c_int] * 4
  lib.pq_decode_paged_smem_bytes.restype = ctypes.c_size_t
  lib.pq_decode_paged_max_g.restype = ctypes.c_int
  lib.pq_decode_paged_max_outputs.restype = ctypes.c_int
  return lib


def _lib_paged() -> ctypes.CDLL:
  """K3's library, its argument types set once."""
  if "lib" not in _LIB_PAGED:
    _LIB_PAGED["lib"] = bind_paged(_build.load("pq_decode_paged"))
  return _LIB_PAGED["lib"]


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


def _check_paged_k3(q, key_codebook, value_codebook, key_index_pool,
                    value_index_pool, tables, layer, length) -> None:
  bh, _, d = q.shape
  check_paged("K3", bh, (key_index_pool, value_index_pool), tables, layer,
              length)
  m = key_index_pool.shape[4]
  if key_codebook.dim() != 4 or key_codebook.shape[:2] != (bh, m) or \
      value_codebook.shape != key_codebook.shape:
    raise ValueError(f"codebooks {tuple(key_codebook.shape)}, "
                     f"{tuple(value_codebook.shape)} must be (BH={bh}, m={m}, "
                     f"K, dsub)")
  if m * key_codebook.shape[3] != d:
    raise ValueError(f"m*dsub = {m}*{key_codebook.shape[3]} != head dim {d}")


# (g, d, m, K) -> True once K3's block takes it
_FITS = {}


def _check_cuda_k3(q, key_codebook, value_codebook, key_index_pool,
                   value_index_pool, tables, length) -> ctypes.CDLL:
  """K3's refusals on CUDA tensors; returns the loaded library."""
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
  _, g, d = q.shape
  _, m, k_cent, _ = key_codebook.shape
  key = (g, d, m, k_cent)
  if key not in _FITS:
    if g > lib.pq_decode_paged_max_g() or \
        g * d > lib.pq_decode_paged_max_outputs():
      raise ValueError(f"K3 takes g <= {lib.pq_decode_paged_max_g()} and g*d "
                       f"<= {lib.pq_decode_paged_max_outputs()}, got g={g}, "
                       f"d={d}")
    smem = lib.pq_decode_paged_smem_bytes(g, d, m, k_cent)
    if smem > SMEM_LIMIT:
      raise ValueError(f"K3 needs {smem} B of shared memory for m={m}, "
                       f"K={k_cent}, d={d}, g={g}; a block has {SMEM_LIMIT}")
    _FITS[key] = True
  return lib


def _paged_args(q, key_codebook, value_codebook, key_index_pool,
                value_index_pool, tables, layer, length):
  """The pointers and geometry both K3 steps take, in their C order."""
  bh, g, d = q.shape
  _, n_layers, n_heads, blk, m = key_index_pool.shape
  ptrs = (q.data_ptr(), key_codebook.data_ptr(), value_codebook.data_ptr(),
          key_index_pool.data_ptr(), value_index_pool.data_ptr(),
          tables.data_ptr(), length.data_ptr())
  geom = (bh, g, d, m, key_codebook.shape[2], n_heads, blk, tables.shape[1],
          n_layers, int(layer))
  return ptrs, geom


def pq_decode_attention_paged(q, key_codebook, value_codebook,
                              key_index_pool, value_index_pool, tables,
                              layer: int, length, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """K3 wrapper: plain version on CPU tensors, the CUDA kernels on CUDA
  tensors (or an error): the split kernel, then the merge, on the split
  `pq_decode_paged_split` picks, from one C call.  `.launches` counts the
  calls that launched them: one per call, although each call runs the two
  kernels."""
  args = (q, key_codebook, value_codebook, key_index_pool, value_index_pool,
          tables, layer, length)
  _check_paged_k3(*args)
  if q.device.type == "cpu":
    return pq_decode_attention_paged_plain(*args, scale)
  lib = _check_cuda_k3(q, key_codebook, value_codebook, key_index_pool,
                       value_index_pool, tables, length)
  bh, g, d = q.shape
  blk = key_index_pool.shape[3]
  n_split, chunk = pq_decode_paged_split(bh, tables.shape[1] * blk,
                                         _build.sm_count(q.device))
  # one allocation: out (BH, g, d), stats (BH, 2, g), then the scratch of
  # the partials, acc (BH, S, g, d) then their stats (BH, S, 2, g)
  n_out = bh * g * (d + 2)
  buf = torch.empty(n_out * (1 + n_split), dtype=torch.float32,
                    device=q.device)
  out = buf[:bh * g * d].view(bh, g, d)
  stats = buf[bh * g * d:n_out].view(bh, 2, g)
  scratch = buf[n_out:]
  ptrs, geom = _paged_args(*args)
  err = lib.pq_decode_paged_launch(
      _Q_CODES[q.dtype], _IDX_CODES[key_index_pool.dtype], *ptrs,
      scratch.data_ptr(), out.data_ptr(), stats.data_ptr(), *geom, n_split,
      chunk, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"pq_decode_attention_paged kernel launch failed: "
                       f"CUDA error {err}")
  pq_decode_attention_paged.launches += 1
  return out, stats


pq_decode_attention_paged.launches = 0


def pq_decode_paged_partials(q, key_codebook, value_codebook, key_index_pool,
                             value_index_pool, tables, layer: int, length,
                             scale: float, n_split: int, chunk: int):
  """K3's first step alone, for checks: the plain partials on CPU tensors,
  the split kernel's on CUDA tensors.  Not counted in
  `pq_decode_attention_paged.launches` (no serving path calls it)."""
  args = (q, key_codebook, value_codebook, key_index_pool, value_index_pool,
          tables, layer, length)
  _check_paged_k3(*args)
  if q.device.type == "cpu":
    return pq_decode_paged_partials_plain(*args, scale, n_split, chunk)
  cap = tables.shape[1] * key_index_pool.shape[3]
  if n_split < 1 or chunk < 1 or chunk % PQ_TILE or \
      (n_split - 1) * chunk >= max(cap, 1):
    raise ValueError(f"split ({n_split}, {chunk}) does not cut {cap} tokens "
                     f"into whole {PQ_TILE}-token tiles")
  lib = _check_cuda_k3(q, key_codebook, value_codebook, key_index_pool,
                       value_index_pool, tables, length)
  bh, g, d = q.shape
  acc = torch.empty((bh, n_split, g, d), dtype=torch.float32, device=q.device)
  stats = torch.empty((bh, n_split, 2, g), dtype=torch.float32,
                      device=q.device)
  ptrs, geom = _paged_args(*args)
  err = lib.pq_decode_paged_split_launch(
      _Q_CODES[q.dtype], _IDX_CODES[key_index_pool.dtype], *ptrs,
      acc.data_ptr(), stats.data_ptr(), *geom, n_split, chunk, float(scale),
      torch.cuda.current_stream(q.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"pq_decode_attention_paged split kernel launch "
                       f"failed: CUDA error {err}")
  return acc, stats


def pq_decode_paged_merge(acc, stats) -> Tuple[torch.Tensor, torch.Tensor]:
  """K3's second step alone, for checks: the plain merge on CPU tensors,
  the merge kernel on CUDA tensors.  Not counted in
  `pq_decode_attention_paged.launches`."""
  bh, n_split, g, d = acc.shape
  if tuple(stats.shape) != (bh, n_split, 2, g):
    raise ValueError(f"stats shape {tuple(stats.shape)} != "
                     f"{(bh, n_split, 2, g)}")
  if acc.device.type == "cpu":
    return pq_decode_paged_merge_plain(acc, stats)
  if (acc.dtype, stats.dtype) != (torch.float32, torch.float32) or not (
      acc.is_contiguous() and stats.is_contiguous()):
    raise TypeError("K3's merge takes contiguous f32 partials")
  if stats.device != acc.device:
    raise ValueError("K3's merge inputs must be on one device")
  _build.require_sm90(acc.device)
  out = torch.empty((bh, g, d), dtype=torch.float32, device=acc.device)
  st = torch.empty((bh, 2, g), dtype=torch.float32, device=acc.device)
  err = _lib_paged().pq_decode_paged_merge_launch(
      acc.data_ptr(), stats.data_ptr(), out.data_ptr(), st.data_ptr(), bh, g,
      d, n_split, torch.cuda.current_stream(acc.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"pq_decode_attention_paged merge kernel launch "
                       f"failed: CUDA error {err}")
  return out, st
