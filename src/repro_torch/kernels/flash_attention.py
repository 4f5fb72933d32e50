"""K7: blockwise flash attention forward (the prefill and `Model.forward`
attention).

`flash_attention` ports `repro/kernels/flash_attention.py::
flash_attention_kernel`: softmax(scale * q k^T) v, causal or not, with GQA
(query head h reads kv head h // (Hq / Hkv)) and the running (max, denom,
acc) of each row in f32; the output is acc / max(denom, 1e-30) in q's
dtype.  On a CPU tensor it takes its plain version (`flash_attention_plain`,
the port's counterpart of `repro/kernels/ref.py::flash_attention_ref`); on a
CUDA tensor it launches `csrc/flash_attention.cu` (its header says what
bounds it on the H100 and how the design answers that) or raises.  There is
no fallback.

Shapes: q (B, Hq, N, d), k and v (B, Hkv, N, d), all bf16 or all f32, d in
{16, 32, 64, 128}.  Unlike the TPU kernel, any N >= 1 is taken: the kernel
masks a ragged last tile itself.  A bf16 block holds 128 (query head,
position) rows of one kv head's group (`block_geometry`), so each K/V tile
is read once per group of up to 4 (d = 64) or 8 query heads.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
SMEM_LIMIT = 232448            # bytes of shared memory one H100 block may use
MAX_GRID_YZ = 65535
MAX_GRID_X = 2 ** 31 - 1
# (query head, position) rows per bf16 block: one warpgroup at d = 64
# (wgmma), eight warps of mma.sync at the other head dims
WGMMA_ROWS, MMA_ROWS = 64, 128
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def block_geometry(g: int, d: int) -> tuple:
  """(heads per block, positions per block) of a bf16 K7 block for g query
  heads per kv head at head dim d: the block's rows (64 at d = 64, else
  128) are hb heads of one kv head's group times pt positions, hb the
  largest of 8, 4, 2, 1 that divides g and leaves pt a multiple of 16 (the
  m-tile)."""
  rows = WGMMA_ROWS if d == 64 else MMA_ROWS
  hb = next(h for h in (8, 4, 2, 1) if g % h == 0 and 16 * h <= rows)
  return hb, rows // hb


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, causal: bool = True, blk: int = 512
                          ) -> torch.Tensor:
  """Plain PyTorch version: blockwise online-softmax attention in f32,
  never materialising the (N, N) scores.

  q (B, Hq, N, d), k/v (B, Hkv, N, d); GQA by grouping q as (B, Hkv, g, N,
  d); blocks of `blk` query and key rows (the last may be short).  When
  causal, key blocks wholly above a query block's diagonal are skipped: they
  would add exactly zero (alpha = 1, p = 0).
  """
  b, hq, sq, d = q.shape
  hkv, sk = k.shape[1], k.shape[2]
  g = hq // hkv
  blk_q = min(blk, sq)
  blk_k = min(blk, sk)
  dev = q.device
  qg = q.reshape(b, hkv, g, sq, d)
  outs = []
  for q0 in range(0, sq, blk_q):
    q_blk = qg[:, :, :, q0:q0 + blk_q].float()
    nq = q_blk.shape[3]
    qpos = q0 + torch.arange(blk_q, device=dev)[:nq]
    acc = torch.zeros((b, hkv, g, nq, d), device=dev)
    m_i = torch.full((b, hkv, g, nq), NEG_INF, device=dev)
    l_i = torch.zeros((b, hkv, g, nq), device=dev)
    for k0 in range(0, sk, blk_k):
      if causal and k0 > q0 + nq - 1:
        break
      k_blk = k[:, :, k0:k0 + blk_k].float()
      v_blk = v[:, :, k0:k0 + blk_k].float()
      s_blk = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, k_blk) * scale
      if causal:
        kpos = k0 + torch.arange(k_blk.shape[2], device=dev)
        mask = kpos[None, :] <= qpos[:, None]
        s_blk = torch.where(mask, s_blk, torch.full_like(s_blk, NEG_INF))
      mu = torch.amax(s_blk, dim=-1)
      m_new = torch.maximum(m_i, mu)
      alpha = torch.exp(m_i - m_new)
      p = torch.exp(s_blk - m_new[..., None])
      l_i = alpha * l_i + torch.sum(p, dim=-1)
      acc = alpha[..., None] * acc + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                  v_blk)
      m_i = m_new
    outs.append(acc / torch.clamp_min(l_i, 1e-30)[..., None])
  out = torch.cat(outs, dim=3)
  return out.reshape(b, hq, sq, d).to(q.dtype)


# f32 inputs: K7 takes FMA on the CUDA cores (no TF32) and differs from the
# plain version only in the order of its f32 sums
F32_ATOL = 1e-5
# no element beyond the reference's bf16 limit (tests/test_kernels.py)
BF16_ATOL_CAP = 3e-2


def kernel_error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, causal: bool, plain: torch.Tensor
                       ) -> torch.Tensor:
  """Elementwise bound, in f32, on |K7 - flash_attention_plain| for the same
  inputs; `plain` is the plain version's output.

  bf16 inputs: the kernel rounds each softmax weight P to bf16 (relative
  error at most 2^-8) before the PV product, while the denominator sums P in
  f32, so its f32 output is within 2^-8 * sum_j (P_j / l) |v_j| -- the plain
  attention of |v| -- of the plain one; both then round to bf16, which adds
  at most 2^-7 |plain|.  Capped at BF16_ATOL_CAP, so no element is held
  more loosely than the reference holds its kernel.  f32 inputs: F32_ATOL.
  """
  if q.dtype == torch.float32:
    return torch.full(plain.shape, F32_ATOL, device=plain.device)
  abs_v = flash_attention_plain(q.float(), k.float(), v.float().abs(), scale,
                                causal)
  return (2.0 ** -8 * abs_v + 2.0 ** -7 * plain.float().abs()
          + F32_ATOL).clamp(max=BF16_ATOL_CAP)


_LIB = {}
# (dtype, d) -> the shared memory of its block, checked once
_SMEM_OK = {}


def _lib() -> ctypes.CDLL:
  """K7's library, its argument types set once."""
  if "lib" not in _LIB:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
    _LIB["lib"] = lib
  return _LIB["lib"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = True) -> torch.Tensor:
  """K7 wrapper: plain version on CPU tensors, the CUDA kernel on CUDA
  tensors (or an error).  Counts its kernel launches in `.launches`."""
  if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
    raise ValueError(f"K7 takes q (B, Hq, N, d) and k, v (B, Hkv, N, d), got "
                     f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
  b, hq, n, d = q.shape
  hkv = k.shape[1]
  if (tuple(k.shape) != (b, hkv, n, d) or tuple(v.shape) != tuple(k.shape)
      or hkv == 0 or hq % hkv):
    raise ValueError(f"k, v shapes {tuple(k.shape)}, {tuple(v.shape)} do not "
                     f"match q {tuple(q.shape)} (Hq a multiple of Hkv)")
  if q.device.type == "cpu":
    return flash_attention_plain(q, k, v, scale, causal)
  if k.device != q.device or v.device != q.device:
    raise ValueError("all K7 inputs must be on one device")
  _build.require_sm90(q.device)
  if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
    raise TypeError(f"q, k, v must share bf16 or f32, got {q.dtype}, "
                    f"{k.dtype}, {v.dtype}")
  if d not in _HEAD_DIMS:
    raise ValueError(f"K7 takes head dim in {_HEAD_DIMS}, got {d}")
  # grids: bf16 (B * Hq / hb, N / pt), f32 (N / 64, Hq, B)
  hb, pt = block_geometry(hq // hkv, d)
  if max(b, hq) > MAX_GRID_YZ or (q.dtype == torch.bfloat16 and (
      -(-n // pt) > MAX_GRID_YZ or b * hq // hb > MAX_GRID_X)):
    raise ValueError(f"K7's grid is out of range for B {b}, Hq {hq}, N {n} "
                     f"(B, Hq and, in bf16, N / {pt} <= {MAX_GRID_YZ})")
  if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
    raise ValueError("K7 inputs must be contiguous")
  if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
    raise ValueError("K7 inputs must be 16-byte aligned")
  lib = _lib()
  if (q.dtype, d) not in _SMEM_OK:
    smem = lib.flash_attention_smem_bytes(_DTYPE_CODES[q.dtype], d)
    if smem > SMEM_LIMIT:
      raise ValueError(f"K7 needs {smem} B of shared memory; a block has "
                       f"{SMEM_LIMIT}")
    _SMEM_OK[(q.dtype, d)] = True
  out = torch.empty_like(q)
  err = lib.flash_attention_launch(
      _DTYPE_CODES[q.dtype], int(bool(causal)), q.data_ptr(), k.data_ptr(),
      v.data_ptr(), out.data_ptr(), b, hq, hkv, n, d, hb, float(scale),
      torch.cuda.current_stream(q.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                       f"{err}")
  flash_attention.launches += 1
  return out


flash_attention.launches = 0
