"""Sub-byte KV packing (GGUF-style block quantization) and K8, the nibble
widen on the card.

Port of `repro/kernels/packing.py`.  Values are grouped along the channel
axis into groups of `group = gcd(d, 32)`; each group stores an f16 scale
((max - min) / (2^bits - 1)), an f16 minimum and `bits`-wide unsigned codes.
At 4 bits the codes are packed *split-half*: byte j of a row carries code j
in its low nibble and code j + d/2 in its high nibble.  q8 stores one byte
per code; q5 stores the q4 layout of the low nibbles followed by a
fifth-bit mask plane (channel j's bit in byte j // 8, bit j % 8).

Codes and f16 headers are bit-equal to the reference: scale and minimum are
rounded through f16 *before* the codes are computed (so a subnormal f16
scale quantizes exactly as there, ROADMAP C4), the codes round half to even
(`torch.round`, as `jnp.round`), and every consumer dequantizes with one
formula, f32(code) * f32(scale) + f32(min), each operation rounded on its
own (the product of a code < 2^8 and an f16 scale is exact in f32).

K8, `unpack_u4_kernel`, ports `unpack_u4_kernel` (a Pallas widen of a
(n, dp) uint8 page to (n, 2*dp) int32 codes): on a CPU tensor it takes the
plain `unpack_u4`, on a CUDA tensor it launches `csrc/unpack_u4.cu` or
raises.  `dequant_page(..., use_kernel=True)` runs its nibble widen through
K8; the contiguous packed store dequantizes that way before K2.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

#: Resident-KV codec registry: CacheSpec.kv_resident_codec key -> code width.
#: "none" keeps the dense float store.
RESIDENT_CODECS = {"none": 0, "q4": 4, "q5": 5, "q8": 8}


def group_size(d: int) -> int:
  """Quant-group length along the channel axis: 32, shrunk to divide d."""
  return math.gcd(d, 32)


def packed_width(d: int, bits: int) -> int:
  """Bytes one packed row of `d` values occupies (codes only)."""
  return d * bits // 8


def quantize_rows(x: torch.Tensor, *, bits: int, group: int):
  """x (..., d) float -> (codes uint8 (..., d), scale f16 (..., G), min f16).

  Asymmetric per-group uniform quantization against the f16-rounded
  parameters; a zero f16 scale gives codes 0 (the group minimum).
  """
  qmax = (1 << bits) - 1
  d = x.shape[-1]
  lead = x.shape[:-1]
  xg = x.float().reshape(*lead, d // group, group)
  lo = torch.amin(xg, dim=-1)
  hi = torch.amax(xg, dim=-1)
  scale = ((hi - lo) / qmax).to(torch.float16)
  mn = lo.to(torch.float16)
  s32 = scale.float()
  safe = torch.where(s32 > 0, s32, torch.ones_like(s32))
  q = torch.clamp(torch.round((xg - mn.float()[..., None]) / safe[..., None]),
                  0, qmax)
  return q.to(torch.uint8).reshape(*lead, d), scale, mn


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor, mn: torch.Tensor,
                    *, group: int) -> torch.Tensor:
  """codes (..., d) int + per-group f16 params -> f32 (..., d)."""
  d = q.shape[-1]
  lead = q.shape[:-1]
  qg = q.float().reshape(*lead, d // group, group)
  x = qg * scale.float()[..., None] + mn.float()[..., None]
  return x.reshape(*lead, d)


def pack_u4(q: torch.Tensor) -> torch.Tensor:
  """(..., d) uint8 nibble codes -> (..., d//2) uint8, split-half layout."""
  dp = q.shape[-1] // 2
  return q[..., :dp] | (q[..., dp:] << 4)


def unpack_u4(p: torch.Tensor) -> torch.Tensor:
  """(..., dp) uint8 -> (..., 2*dp) int32 nibble codes (the plain K8)."""
  pi = p.to(torch.int32)
  return torch.cat([pi & 0xF, (pi >> 4) & 0xF], dim=-1)


def pack_u5(q: torch.Tensor) -> torch.Tensor:
  """(..., d) uint8 5-bit codes -> (..., 5*d//8) uint8: the low nibbles in
  the q4 layout, then the fifth-bit plane, LSB first.  d % 8 == 0."""
  d = q.shape[-1]
  lo = pack_u4(q & 0xF)
  hb = ((q >> 4) & 1).to(torch.int32).reshape(*q.shape[:-1], d // 8, 8)
  weights = 1 << torch.arange(8, dtype=torch.int32, device=q.device)
  hi = torch.sum(hb * weights, dim=-1).to(torch.uint8)
  return torch.cat([lo, hi], dim=-1)


def unpack_u5(p: torch.Tensor, unpack4=unpack_u4) -> torch.Tensor:
  """(..., 5*d//8) uint8 -> (..., d) int32 codes: the q4 unpack of the low
  nibbles (through `unpack4`) plus one masked or of the fifth bit."""
  d = p.shape[-1] * 8 // 5
  lo = unpack4(p[..., :d // 2])
  hi = p[..., d // 2:].to(torch.int32)
  shifts = torch.arange(8, dtype=torch.int32, device=p.device)
  bit = ((hi[..., :, None] >> shifts) & 1).reshape(*p.shape[:-1], d)
  return lo | (bit << 4)


def pack_rows(x: torch.Tensor, *, bits: int, group: int):
  """x (..., d) float -> (packed uint8 (..., d*bits/8), scale f16, min f16)."""
  q, scale, mn = quantize_rows(x, bits=bits, group=group)
  if bits == 4:
    return pack_u4(q), scale, mn
  if bits == 5:
    return pack_u5(q), scale, mn
  return q, scale, mn


def _unpack4_rows(p: torch.Tensor) -> torch.Tensor:
  """K8 over the leading dims of a (..., dp) page."""
  dp = p.shape[-1]
  return unpack_u4_kernel(p.reshape(-1, dp).contiguous()).reshape(
      *p.shape[:-1], 2 * dp)


def dequant_page(pack: torch.Tensor, scale: torch.Tensor, mn: torch.Tensor,
                 *, bits: int, group: int,
                 use_kernel: bool = False) -> torch.Tensor:
  """Packed page (..., d*bits/8) uint8 + f16 headers -> f32 values (..., d).

  With `use_kernel` the nibble widen of q4 and of q5's low nibbles runs
  through K8; the codes, and so the values, are the same either way.
  """
  unpack4 = _unpack4_rows if use_kernel else unpack_u4
  if bits == 4:
    q = unpack4(pack)
  elif bits == 5:
    q = unpack_u5(pack, unpack4)
  else:
    q = pack.to(torch.int32)
  return dequantize_rows(q, scale, mn, group=group)


# ---------------------------------------------------------------------------
# K8: the nibble widen on the card
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
  lib = _build.load("unpack_u4")
  fn = lib.unpack_u4_launch
  fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_void_p]
  fn.restype = ctypes.c_int
  return lib


def unpack_u4_kernel(p: torch.Tensor) -> torch.Tensor:
  """K8 wrapper: (n, dp) uint8 -> (n, 2*dp) int32 split-half nibble codes.

  Plain `unpack_u4` on a CPU tensor, the CUDA kernel on a CUDA tensor (or
  an error).  Counts its kernel launches in `.launches`.
  """
  if p.dim() != 2:
    raise ValueError(f"K8 takes a (n, dp) page, got shape {tuple(p.shape)}")
  if p.dtype != torch.uint8:
    raise TypeError(f"K8 takes uint8 codes, got {p.dtype}")
  if p.device.type == "cpu":
    return unpack_u4(p)
  _build.require_sm90(p.device)
  if not p.is_contiguous():
    raise ValueError("K8 input must be contiguous")
  n, dp = p.shape
  out = torch.empty((n, 2 * dp), dtype=torch.int32, device=p.device)
  err = _lib().unpack_u4_launch(
      p.data_ptr(), out.data_ptr(), n, dp,
      torch.cuda.current_stream(p.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"unpack_u4 kernel launch failed: CUDA error {err}")
  unpack_u4_kernel.launches += 1
  return out


unpack_u4_kernel.launches = 0
