"""K6: the k-means assignment step of the PQ prefill.

`kmeans_assign` ports `repro/kernels/kmeans_assign.py::kmeans_assign_kernel`:
nearest-centroid ids for R independent problems, argmin_k(||c_k||^2 -
2 x.c_k) in f32 with ||x||^2 dropped, ties to the first index.  On a CPU
tensor it takes its plain version (`kmeans_assign_plain`); on a CUDA tensor
it launches `csrc/kmeans_assign.cu` (its header says what bounds it on the
H100 and how the design answers that) or raises.  There is no fallback.

Shapes: x (R, N, dsub) and centroids (R, K, dsub), each bf16 or f32, R the
flattened leading dimensions (batch, head, subvector) of the batched k-means
in place of the TPU kernel's m grid axis.  Returns (R, N) int32.

On the card each thread holds 4 points and walks the row's centroids, split
over 1, 2 or 4 neighbouring lanes (`kmeans_assign_geometry` picks the split
from R, N, K and the SM count, so that the prefill's R = 512 and an engine
admission's R = 128 both fill the card).

Dropping ||x||^2 changes the rounding of each distance, so on a near-tie
the id may differ from `core.kmeans.assign_clusters` (the full distance);
on tie-free inputs the two agree.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SMEM_LIMIT = 232448            # bytes of shared memory one H100 block may use
THREADS = 256                  # threads of a K6 block
POINTS = 4                     # points each thread holds (the kernel's kP)
LANES = (1, 2, 4)              # splits of a row's centroids over lanes
MAX_BLOCKS = 2 ** 31 - 1       # the grid's x axis: (row, tile of points)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_DSUBS = (1, 2, 4, 8, 16)


def kmeans_assign_plain(x: torch.Tensor, centroids: torch.Tensor
                        ) -> torch.Tensor:
  """Plain PyTorch version: argmin of ||c||^2 - 2 x.c in f32, the sums
  taken channel by channel with every product and sum rounded on its own,
  as the kernel takes them (so the two agree bit for bit, ties included)."""
  x = x.float()
  c = centroids.float()
  c_sq = c[..., 0] * c[..., 0]                                # (R, K)
  cross = x[:, :, None, 0] * c[:, None, :, 0]                 # (R, N, K)
  for e in range(1, x.shape[-1]):
    c_sq = c_sq + c[..., e] * c[..., e]
    cross = cross + x[:, :, None, e] * c[:, None, :, e]
  return torch.argmin(c_sq[:, None, :] - 2.0 * cross, dim=-1).to(torch.int32)


def kmeans_assign_geometry(r: int, n: int, k: int,
                           sms: int = _build.H100_SMS) -> int:
  """L: K6's split of a row's K centroids over L neighbouring lanes.

  The least L of (1, 2, 4) at which the launch has at least 3 blocks per SM
  (24 warps each), where a block of 256 threads holds 256 / L * 4 points,
  or 4 if none does; never more lanes than centroids.  At R = 512, N =
  1024 this is 1 (512 blocks), at R = 128 it is 4 (512 blocks).
  """
  for lanes in LANES:
    per_block = THREADS // lanes * POINTS
    if lanes * 2 > k or r * -(-n // per_block) >= 3 * sms:
      return lanes
  return LANES[-1]


_LIB = {}


def _lib() -> ctypes.CDLL:
  """K6's library, its argument types set once."""
  if "lib" not in _LIB:
    lib = _build.load("kmeans_assign")
    fn = lib.kmeans_assign_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.kmeans_assign_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.kmeans_assign_smem_bytes.restype = ctypes.c_size_t
    _LIB["lib"] = lib
  return _LIB["lib"]


# (K, dsub) -> True once K6's block takes it
_FITS = {}


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
  """K6 wrapper: plain version on CPU tensors, the CUDA kernel on CUDA
  tensors (or an error).  Counts its kernel launches in `.launches`."""
  if x.dim() != 3 or centroids.dim() != 3:
    raise ValueError(f"K6 takes x (R, N, dsub) and centroids (R, K, dsub), "
                     f"got {tuple(x.shape)} and {tuple(centroids.shape)}")
  r, n, dsub = x.shape
  k = centroids.shape[1]
  if centroids.shape[0] != r or centroids.shape[2] != dsub or k == 0:
    raise ValueError(f"centroids shape {tuple(centroids.shape)} does not "
                     f"match x {tuple(x.shape)}")
  if x.device.type == "cpu":
    return kmeans_assign_plain(x, centroids)
  if centroids.device != x.device:
    raise ValueError("K6 inputs must be on one device")
  _build.require_sm90(x.device)
  if x.dtype not in _DTYPE_CODES or centroids.dtype not in _DTYPE_CODES:
    raise TypeError(f"x and centroids must be bf16 or f32, got {x.dtype}, "
                    f"{centroids.dtype}")
  if dsub not in _DSUBS:
    raise ValueError(f"K6 takes dsub in {_DSUBS}, got {dsub}")
  if not (x.is_contiguous() and centroids.is_contiguous()):
    raise ValueError("K6 inputs must be contiguous")
  lanes = kmeans_assign_geometry(r, n, k, _build.sm_count(x.device))
  if r * -(-n // (THREADS // lanes * POINTS)) > MAX_BLOCKS:
    raise ValueError(f"K6's grid cannot hold R={r} rows of N={n} points")
  lib = _lib()
  if (k, dsub) not in _FITS:
    smem = lib.kmeans_assign_smem_bytes(k, dsub)
    if smem > SMEM_LIMIT:
      raise ValueError(f"K6 needs {smem} B of shared memory for K={k}; a "
                       f"block has {SMEM_LIMIT}")
    _FITS[(k, dsub)] = True
  out = torch.empty((r, n), dtype=torch.int32, device=x.device)
  err = lib.kmeans_assign_launch(
      _DTYPE_CODES[x.dtype], _DTYPE_CODES[centroids.dtype], x.data_ptr(),
      centroids.data_ptr(), out.data_ptr(), r, n, k, dsub, lanes,
      torch.cuda.current_stream(x.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"kmeans_assign kernel launch failed: CUDA error {err}")
  kmeans_assign.launches += 1
  return out


kmeans_assign.launches = 0
