"""K2, K4 and K5: GQA flash decode (the exact policy's decode kernels).

K2, `flash_decode`, ports `repro/kernels/paged_flash_decode.py::
flash_decode_kernel` (dense K/V, the contiguous layout); K4,
`paged_flash_decode`, ports `paged_flash_decode_kernel` (K/V pages read in
place from the paged layout's pools through block tables); K5,
`packed_paged_flash_decode`, ports `packed_paged_flash_decode_kernel` (the
same over the packed resident store's code and f16 header pools, each
element dequantized on load).  Each wrapper takes its plain version
(`*_plain`) for a CPU tensor, and for a CUDA tensor launches its kernel
(`csrc/flash_decode.cu`, `csrc/paged_flash_decode.cu`,
`csrc/packed_paged_flash_decode.cu`; their headers say what bounds them on
the H100 and how their design answers that) or raises.  There is no
fallback from a kernel to its plain version.

K2 runs in two steps on the card: a split kernel over (row, chunk of the
sequence) writes unnormalised partials and a merge kernel combines them in
chunk order (`flash_decode_split` picks the chunks from the capacity; the
steps' plain versions are `flash_decode_partials_plain` and
`flash_decode_merge_plain`).  K5 runs its own split kernel over the pages
(decoding each tile as it loads it) and then K2's merge, on K2's split
(plain first step: `packed_paged_flash_decode_partials_plain`).

Shapes, as the TPU kernels: q (BH, g, d) in the cache dtype (K5: bf16 or
f32); K2 k, v (BH, N, d) with length (BH,) int32 valid tokens; K4 pools
(P+1, L, H, blk, d) with tables (B, nb) int32, a Python-int layer and length
(B,) int32, row bh reading request bh // H and head bh % H; K5 six pools,
codes (P+1, L, H, blk, d*bits/8) uint8 and scale, min (P+1, L, H, blk, G)
f16 for each of K and V.  Returns (BH, g, d) f32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import pq_attention as pqa
from repro_torch.kernels import _build, packing
from repro_torch.kernels.pq_decode import check_paged, dense_pages

SMEM_LIMIT = 232448            # bytes of shared memory one H100 block may use
H100_SMS = _build.H100_SMS
DECODE_TILE = 64               # K2's token tile; its chunks are whole tiles
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def flash_decode_plain(q, k, v, length, scale: float) -> torch.Tensor:
  """Plain PyTorch version: masked softmax attention in f32 (zero output
  for a row with length 0, as the kernel)."""
  n = k.shape[1]
  mask = torch.arange(n, device=q.device)[None, :] < length[:, None].long()
  out, _, _ = pqa.segment_attention_stats(q, k, v, mask, scale)
  return out


def flash_decode_split(bh: int, n: int, sms: int = H100_SMS) -> tuple:
  """(S, chunk): K2's split of a capacity of n tokens over S blocks per row.

  From the capacity and the SM count alone (never the device `length`, which
  would cost a host sync): S = ceil(2 sms / bh), so that bh * S fills the
  SMs about twice, capped at the number of 64-token tiles; chunk = whole
  tiles, 64 ceil(tiles / S); S is then recounted so every chunk starts below
  n.  Chunk s covers tokens [s chunk, min((s + 1) chunk, n)).
  """
  tiles = max(1, -(-n // DECODE_TILE))
  s = max(1, min(-(-2 * sms // max(bh, 1)), tiles))
  chunk = DECODE_TILE * -(-tiles // s)
  return -(-max(n, 1) // chunk), chunk


def flash_decode_partials_plain(q, k, v, length, scale: float, n_split: int,
                                chunk: int):
  """Plain version of K2's first step: each chunk's unnormalised partial.

  Returns acc (BH, S, g, d) = sum_t e^(s_t - m) v_t, and stats (BH, S, 2, g)
  = (m, sum_t e^(s_t - m)) over the chunk's tokens below `length`, in f32;
  a chunk with no such token gives (0, -inf, 0).
  """
  bh, g, d = q.shape
  n = k.shape[1]
  qf, kf, vf = q.float(), k.float(), v.float()
  accs, stats = [], []
  for s in range(n_split):
    t0, t1 = s * chunk, min((s + 1) * chunk, n)
    pos = torch.arange(t0, t1, device=q.device)
    mask = (pos[None, :] < length[:, None].long())[:, None, :]  # (BH, 1, c)
    sc = torch.einsum("bgd,btd->bgt", qf, kf[:, t0:t1]) * scale
    sc = torch.where(mask, sc, torch.full_like(sc, float("-inf")))
    m = (torch.amax(sc, dim=-1) if t1 > t0
         else torch.full((bh, g), float("-inf"), device=q.device))
    base = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(sc - base[..., None])
    accs.append(torch.einsum("bgt,btd->bgd", p, vf[:, t0:t1]))
    stats.append(torch.stack([m, p.sum(-1)], dim=1))
  return torch.stack(accs, dim=1), torch.stack(stats, dim=1)


def flash_decode_merge_plain(acc, stats) -> torch.Tensor:
  """Plain version of K2's second step: the flash-decoding combine of the
  partials, (BH, S, g, d) and (BH, S, 2, g) -> normalised (BH, g, d) f32;
  a row whose partials are all empty gives 0."""
  m, l = stats[:, :, 0], stats[:, :, 1]
  top = torch.amax(m, dim=1, keepdim=True)
  base = torch.where(top == float("-inf"), torch.zeros_like(top), top)
  w = torch.exp(m - base)
  num = (w[..., None] * acc).sum(dim=1)
  den = (w * l).sum(dim=1)
  return num / den.clamp_min(1e-30)[..., None]


_LIB = {}


def _lib() -> ctypes.CDLL:
  """K2's library, its argument types set once."""
  if "lib" not in _LIB:
    lib = _build.load("flash_decode")
    fn = lib.flash_decode_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.flash_decode_split_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.flash_decode_merge_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_decode_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_decode_smem_bytes.restype = ctypes.c_size_t
    lib.flash_decode_max_outputs.restype = ctypes.c_int
    _LIB["lib"] = lib
  return _LIB["lib"]


# (dtype, g, d) -> True once K2's block takes it
_FITS = {}


def _check_decode(q, k, v, length):
  bh, g, d = q.shape
  n = k.shape[1]
  for name, t, shape in (("k", k, (bh, n, d)), ("v", v, (bh, n, d)),
                         ("length", length, (bh,))):
    if tuple(t.shape) != shape:
      raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")


def _check_cuda(q, k, v, length) -> ctypes.CDLL:
  """K2's refusals on CUDA tensors; returns the loaded library."""
  _, g, d = q.shape
  dev = q.device
  if k.device != dev or v.device != dev or length.device != dev:
    raise ValueError("all K2 inputs must be on one device")
  _build.require_sm90(dev)
  if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
    raise TypeError(f"q, k, v must share bf16 or f32, got {q.dtype}, "
                    f"{k.dtype}, {v.dtype}")
  if length.dtype != torch.int32:
    raise TypeError(f"length must be int32, got {length.dtype}")
  if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
          and length.is_contiguous()):
    raise ValueError("K2 inputs must be contiguous")
  lib = _lib()
  key = (q.dtype, g, d)
  if key not in _FITS:
    if g * d > lib.flash_decode_max_outputs():
      raise ValueError(f"K2 takes g*d <= {lib.flash_decode_max_outputs()}, "
                       f"got g={g}, d={d}")
    smem = lib.flash_decode_smem_bytes(_DTYPE_CODES[q.dtype], g, d)
    if smem > SMEM_LIMIT:
      raise ValueError(f"K2 needs {smem} B of shared memory; a block has "
                       f"{SMEM_LIMIT}")
    _FITS[key] = True
  return lib


def _stream(t) -> int:
  return torch.cuda.current_stream(t.device).cuda_stream


def _split_cuda(lib, q, k, v, length, scale, n_split, chunk):
  bh, g, d = q.shape
  acc = torch.empty((bh, n_split, g, d), dtype=torch.float32, device=q.device)
  stats = torch.empty((bh, n_split, 2, g), dtype=torch.float32,
                      device=q.device)
  err = lib.flash_decode_split_launch(
      _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
      length.data_ptr(), acc.data_ptr(), stats.data_ptr(), bh, g, d,
      k.shape[1], n_split, chunk, float(scale), _stream(q))
  if err != 0:
    raise RuntimeError(f"flash_decode split kernel launch failed: CUDA error "
                       f"{err}")
  return acc, stats


def flash_decode(q, k, v, length, scale: float) -> torch.Tensor:
  """K2 wrapper: plain version on CPU tensors, the CUDA kernels on CUDA
  tensors (or an error): the split kernel, then the merge, on the split
  `flash_decode_split` picks, from one C call.  `.launches` counts the calls
  that launched them: one per call, although each call runs the two
  kernels."""
  _check_decode(q, k, v, length)
  if q.device.type == "cpu":
    return flash_decode_plain(q, k, v, length, scale)
  lib = _check_cuda(q, k, v, length)
  bh, g, d = q.shape
  n = k.shape[1]
  n_split, chunk = flash_decode_split(bh, n, _build.sm_count(q.device))
  # scratch: the partials, acc (BH, S, g, d) then stats (BH, S, 2, g)
  scratch = torch.empty(bh * n_split * g * (d + 2), dtype=torch.float32,
                        device=q.device)
  out = torch.empty((bh, g, d), dtype=torch.float32, device=q.device)
  err = lib.flash_decode_launch(
      _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
      length.data_ptr(), scratch.data_ptr(), out.data_ptr(), bh, g, d, n,
      n_split, chunk, float(scale), _stream(q))
  if err != 0:
    raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {err}")
  flash_decode.launches += 1
  return out


flash_decode.launches = 0


def flash_decode_partials(q, k, v, length, scale: float, n_split: int,
                          chunk: int):
  """K2's first step alone, for checks: the plain partials on CPU tensors,
  the split kernel's on CUDA tensors.  Not counted in
  `flash_decode.launches` (no serving path calls it)."""
  _check_decode(q, k, v, length)
  if q.device.type == "cpu":
    return flash_decode_partials_plain(q, k, v, length, scale, n_split, chunk)
  if n_split < 1 or chunk < 1 or (n_split - 1) * chunk >= max(k.shape[1], 1):
    raise ValueError(f"split ({n_split}, {chunk}) does not cut "
                     f"{k.shape[1]} tokens")
  lib = _check_cuda(q, k, v, length)
  return _split_cuda(lib, q, k, v, length, scale, n_split, chunk)


def flash_decode_merge(acc, stats) -> torch.Tensor:
  """K2's second step alone, for checks: the plain merge on CPU tensors,
  the merge kernel on CUDA tensors.  Not counted in `flash_decode.launches`.
  """
  bh, n_split, g, d = acc.shape
  if tuple(stats.shape) != (bh, n_split, 2, g):
    raise ValueError(f"stats shape {tuple(stats.shape)} != "
                     f"{(bh, n_split, 2, g)}")
  if acc.device.type == "cpu":
    return flash_decode_merge_plain(acc, stats)
  if (acc.dtype, stats.dtype) != (torch.float32, torch.float32) or not (
      acc.is_contiguous() and stats.is_contiguous()):
    raise TypeError("K2's merge takes contiguous f32 partials")
  if stats.device != acc.device:
    raise ValueError("K2's merge inputs must be on one device")
  _build.require_sm90(acc.device)
  out = torch.empty((bh, g, d), dtype=torch.float32, device=acc.device)
  err = _lib().flash_decode_merge_launch(
      acc.data_ptr(), stats.data_ptr(), out.data_ptr(), bh, g, d, n_split,
      _stream(acc))
  if err != 0:
    raise RuntimeError(f"flash_decode merge kernel launch failed: CUDA error "
                       f"{err}")
  return out


# ---------------------------------------------------------------------------
# K4: K/V pages read in place from the block pools
# ---------------------------------------------------------------------------

def paged_flash_decode_plain(q, k_pool, v_pool, tables, layer: int, length,
                             scale: float) -> torch.Tensor:
  """Plain PyTorch version of K4: gather the table-mapped pages of plane
  `layer` into dense (BH, nb * blk, d) K/V and run K2's plain version."""
  n_heads = k_pool.shape[2]
  return flash_decode_plain(q, dense_pages(k_pool, tables, layer),
                            dense_pages(v_pool, tables, layer),
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


# ---------------------------------------------------------------------------
# K5: packed pages (codes + f16 scale/min) dequantized on load
# ---------------------------------------------------------------------------

def packed_paged_flash_decode_plain(q, k_pack, k_scale, k_min, v_pack,
                                    v_scale, v_min, tables, layer: int,
                                    length, scale: float,
                                    bits: int) -> torch.Tensor:
  """Plain PyTorch version of K5: gather the table-mapped pages of plane
  `layer`, dequantize them with `packing.dequant_page` and run K2's plain
  version on the f32 values."""
  n_heads = k_pack.shape[2]
  group = q.shape[-1] // k_scale.shape[4]

  def dense(pack, sc, mn):
    return packing.dequant_page(
        dense_pages(pack, tables, layer), dense_pages(sc, tables, layer),
        dense_pages(mn, tables, layer), bits=bits, group=group)
  return flash_decode_plain(q, dense(k_pack, k_scale, k_min),
                            dense(v_pack, v_scale, v_min),
                            length.repeat_interleave(n_heads), scale)


def packed_paged_flash_decode_partials_plain(q, k_pack, k_scale, k_min,
                                             v_pack, v_scale, v_min, tables,
                                             layer: int, length, scale: float,
                                             bits: int, n_split: int,
                                             chunk: int):
  """Plain version of K5's first step: the table-mapped pages of plane
  `layer`, dequantized with `packing.dequant_page`, through K2's plain
  partials (`flash_decode_partials_plain`): acc (BH, S, g, d) and stats
  (BH, S, 2, g) f32.  K2's merge (`flash_decode_merge_plain`) is its second
  step."""
  n_heads = k_pack.shape[2]
  group = q.shape[-1] // k_scale.shape[4]
  k, v = (packing.dequant_page(
      dense_pages(pack, tables, layer), dense_pages(sc, tables, layer),
      dense_pages(mn, tables, layer), bits=bits, group=group)
      for pack, sc, mn in ((k_pack, k_scale, k_min), (v_pack, v_scale, v_min)))
  return flash_decode_partials_plain(q, k, v, length.repeat_interleave(n_heads),
                                     scale, n_split, chunk)


def _lib_packed() -> ctypes.CDLL:
  """K5's library, its argument types set once."""
  if "packed" not in _LIB:
    lib = _build.load("packed_paged_flash_decode")
    fn = lib.packed_paged_flash_decode_split_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 11
                   + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.packed_paged_flash_decode_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.packed_paged_flash_decode_smem_bytes.restype = ctypes.c_size_t
    lib.packed_paged_flash_decode_max_outputs.restype = ctypes.c_int
    _LIB["packed"] = lib
  return _LIB["packed"]


def _check_packed(q, k_pack, k_scale, k_min, v_pack, v_scale, v_min, tables,
                  layer, length, bits) -> None:
  """K5's shape rules (on every device)."""
  bh, g, d = q.shape
  packs, headers = (k_pack, v_pack), (k_scale, k_min, v_scale, v_min)
  check_paged("K5", bh, packs, tables, layer, length)
  check_paged("K5", bh, headers, tables, layer, length)
  if bits not in (4, 5, 8) or (bits == 5 and d % 8) or d % 2:
    raise ValueError(f"K5 takes bits 4, 5 or 8 (5 with d % 8 == 0), got "
                     f"bits={bits}, d={d}")
  n_groups = k_scale.shape[4]
  if k_pack.shape[:4] != k_scale.shape[:4] or d % n_groups:
    raise ValueError(f"K5: code pools {tuple(k_pack.shape)} and header pools "
                     f"{tuple(k_scale.shape)} do not match d={d}")
  if k_pack.shape[4] != packing.packed_width(d, bits):
    raise ValueError(f"K5: code rows {k_pack.shape[4]} != "
                     f"{packing.packed_width(d, bits)} bytes for d={d} at "
                     f"{bits} bits")


# (g, d, n_groups) -> True once K5's block takes it
_FITS_PACKED = {}


def _check_packed_cuda(q, pools, tables, length) -> ctypes.CDLL:
  """K5's refusals on CUDA tensors; returns the loaded library."""
  _, g, d = q.shape
  k_pack, k_scale = pools[0], pools[1]
  tensors = (q, *pools, tables, length)
  if any(t.device != q.device for t in tensors):
    raise ValueError("all K5 inputs must be on one device")
  _build.require_sm90(q.device)
  if q.dtype not in _DTYPE_CODES:
    raise TypeError(f"q must be bf16 or f32, got {q.dtype}")
  if k_pack.dtype != torch.uint8 or k_scale.dtype != torch.float16:
    raise TypeError(f"K5 pools must be uint8 codes and f16 headers, got "
                    f"{k_pack.dtype}, {k_scale.dtype}")
  if tables.dtype != torch.int32 or length.dtype != torch.int32:
    raise TypeError(f"tables and length must be int32, got {tables.dtype}, "
                    f"{length.dtype}")
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError("K5 inputs must be contiguous")
  lib = _lib_packed()
  key = (g, d, k_scale.shape[4])
  if key not in _FITS_PACKED:
    if d % 16 or (d // k_scale.shape[4]) % 8:
      raise ValueError(f"K5's kernel takes d % 16 == 0 and quant groups of a "
                       f"multiple of 8 channels, got d={d}, "
                       f"{k_scale.shape[4]} groups")
    if g * d > lib.packed_paged_flash_decode_max_outputs():
      raise ValueError(f"K5 takes g*d <= "
                       f"{lib.packed_paged_flash_decode_max_outputs()}, got "
                       f"g={g}, d={d}")
    smem = lib.packed_paged_flash_decode_smem_bytes(g, d)
    if smem > SMEM_LIMIT:
      raise ValueError(f"K5 needs {smem} B of shared memory; a block has "
                       f"{SMEM_LIMIT}")
    _FITS_PACKED[key] = True
  return lib


def _packed_split_cuda(lib, q, pools, tables, layer, length, scale, bits,
                       n_split, chunk, acc, stats) -> None:
  """K5's split kernel into the partials acc (BH, S, g, d), stats (BH, S, 2,
  g)."""
  bh, g, d = q.shape
  _, n_layers, n_heads, blk, _ = pools[0].shape
  err = lib.packed_paged_flash_decode_split_launch(
      _DTYPE_CODES[q.dtype], bits, q.data_ptr(),
      *(t.data_ptr() for t in pools), tables.data_ptr(), length.data_ptr(),
      acc.data_ptr(), stats.data_ptr(), bh, g, d, n_heads, blk,
      tables.shape[1], n_layers, int(layer), pools[1].shape[4], n_split,
      chunk, float(scale), _stream(q))
  if err != 0:
    raise RuntimeError(f"packed_paged_flash_decode split kernel launch "
                       f"failed: CUDA error {err}")


def packed_paged_flash_decode(q, k_pack, k_scale, k_min, v_pack, v_scale,
                              v_min, tables, layer: int, length, scale: float,
                              bits: int) -> torch.Tensor:
  """K5 wrapper: plain version on CPU tensors, the CUDA kernels on CUDA
  tensors (or an error): K5's split kernel over the pages, then K2's merge,
  on the split `flash_decode_split` picks from the capacity.  `.launches`
  counts the calls that launched them: one per call, although each call
  runs the two kernels."""
  pools = (k_pack, k_scale, k_min, v_pack, v_scale, v_min)
  _check_packed(q, *pools, tables, layer, length, bits)
  if q.device.type == "cpu":
    return packed_paged_flash_decode_plain(q, *pools, tables, layer, length,
                                           scale, bits)
  lib = _check_packed_cuda(q, pools, tables, length)
  bh, g, d = q.shape
  n_split, chunk = flash_decode_split(bh, tables.shape[1] * k_pack.shape[3],
                                      _build.sm_count(q.device))
  # one allocation: out (BH, g, d), then the partials, acc (BH, S, g, d)
  # and stats (BH, S, 2, g)
  n_out, n_acc = bh * g * d, bh * n_split * g * d
  buf = torch.empty(n_out + n_acc + bh * n_split * 2 * g,
                    dtype=torch.float32, device=q.device)
  out = buf[:n_out].view(bh, g, d)
  acc, stats = buf[n_out:n_out + n_acc], buf[n_out + n_acc:]
  _packed_split_cuda(lib, q, pools, tables, layer, length, scale, bits,
                     n_split, chunk, acc, stats)
  err = _lib().flash_decode_merge_launch(
      acc.data_ptr(), stats.data_ptr(), out.data_ptr(), bh, g, d, n_split,
      _stream(q))
  if err != 0:
    raise RuntimeError(f"flash_decode merge kernel launch failed (K5): CUDA "
                       f"error {err}")
  packed_paged_flash_decode.launches += 1
  return out


packed_paged_flash_decode.launches = 0


def packed_paged_flash_decode_partials(q, k_pack, k_scale, k_min, v_pack,
                                       v_scale, v_min, tables, layer: int,
                                       length, scale: float, bits: int,
                                       n_split: int, chunk: int):
  """K5's first step alone, for checks: the plain partials on CPU tensors,
  the split kernel's on CUDA tensors (acc (BH, S, g, d), stats (BH, S, 2,
  g)); `flash_decode_merge` is the second step.  Not counted in
  `packed_paged_flash_decode.launches` (no serving path calls it)."""
  pools = (k_pack, k_scale, k_min, v_pack, v_scale, v_min)
  _check_packed(q, *pools, tables, layer, length, bits)
  if q.device.type == "cpu":
    return packed_paged_flash_decode_partials_plain(
        q, *pools, tables, layer, length, scale, bits, n_split, chunk)
  cap = tables.shape[1] * k_pack.shape[3]
  if n_split < 1 or chunk < 1 or (n_split - 1) * chunk >= max(cap, 1):
    raise ValueError(f"split ({n_split}, {chunk}) does not cut {cap} tokens")
  lib = _check_packed_cuda(q, pools, tables, length)
  bh, g, d = q.shape
  acc = torch.empty((bh, n_split, g, d), dtype=torch.float32,
                    device=q.device)
  stats = torch.empty((bh, n_split, 2, g), dtype=torch.float32,
                      device=q.device)
  _packed_split_cuda(lib, q, pools, tables, layer, length, scale, bits,
                     n_split, chunk, acc, stats)
  return acc, stats
