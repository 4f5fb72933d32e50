"""B0: the k-means centroid update of the PQ prefill.

`kmeans_update` computes one weighted centroid update (AQPIM Eq. 2) for R
independent problems: the function of `repro/core/kmeans.py::
_weighted_update`, which the reference writes in plain JAX (a one-hot (N, K)
matmul for the TPU's matrix unit), not as a Pallas kernel.  For each row and
cluster k it divides the weighted sum of the member points by their weight
mass; a cluster whose mass is at most 1e-12 keeps its old centroid.

On a CPU tensor the wrapper takes its plain version (`kmeans_update_plain`,
the reference's one-hot form, so the CPU path keeps its arithmetic); on a
CUDA tensor it launches `csrc/kmeans_update.cu` (its header says what bounds
it on the H100 and how the design answers that) or raises.  There is no
fallback.  The kernel is deterministic: it sums each cluster's members in
ascending point order, without atomics, so two calls give the same bits.
It streams each row through shared memory in tiles, so N is unbounded; K
is bounded by the block's shared memory (K up to 4415 at dsub 2, 1486 at
dsub 16 on the H100).

Shapes: x (R, N, dsub) bf16 or f32, w (R, N) f32, assign (R, N) int32 in
[0, K), centroids (R, K, dsub) f32, R the flattened leading dimensions
(batch, head, subvector) of the batched k-means.  Returns (R, K, dsub) f32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SMEM_LIMIT = 232448            # bytes of shared memory one H100 block may use
EMPTY = 1e-12                  # a weight mass at or below it freezes a cluster
# The kernel against the plain version, per element: both sum the same f32
# terms in other orders (the kernel member by member in ascending n, the
# plain version in a matmul), so they differ by a few roundings of the
# largest partial sum; 1e-5 of the cluster's mean |w x| leaves a factor of
# ~10 over the rounding of a 1024-member sum, and 1e-7 covers centroids
# near 0.
REL_TOL, ABS_TOL = 1e-5, 1e-7
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_DSUBS = (1, 2, 4, 8, 16)


def kmeans_update_plain(x: torch.Tensor, w: torch.Tensor, assign: torch.Tensor,
                        centroids: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch version, the reference's one-hot-matmul form.  Takes any
  leading dims: x (..., N, d), w (..., N), assign (..., N), centroids
  (..., K, d) -> (..., K, d) f32."""
  k = centroids.shape[-2]
  onehot = torch.nn.functional.one_hot(assign.long(), k).float()  # (..., N, K)
  wo = onehot * w.float()[..., None]
  num = torch.matmul(wo.transpose(-1, -2), x.float())           # (..., K, d)
  den = torch.sum(wo, dim=-2)                                   # (..., K)
  new_centroids = num / torch.clamp_min(den, EMPTY)[..., None]
  empty = (den <= EMPTY)[..., None]
  return torch.where(empty, centroids.float(), new_centroids)


def kmeans_update_tolerance(x, w, assign, centroids):
  """(tol (..., K, d), empty (..., K)): the bound the kernel is held to
  against the plain version element by element, REL_TOL x the cluster's
  sum of |w x| over its mass, plus ABS_TOL; and the frozen clusters, which
  must equal the old centroid bit for bit."""
  k = centroids.shape[-2]
  wo = torch.nn.functional.one_hot(assign.long(), k).float() * \
      w.float()[..., None]
  den = torch.sum(wo, dim=-2)
  mag = torch.matmul(wo.abs().transpose(-1, -2), x.float().abs())
  tol = REL_TOL * mag / torch.clamp_min(den, EMPTY)[..., None] + ABS_TOL
  return tol, den <= EMPTY


_LIB = {}


def _lib() -> ctypes.CDLL:
  """B0's library, its argument types set once."""
  if "lib" not in _LIB:
    lib = _build.load("kmeans_update")
    fn = lib.kmeans_update_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.kmeans_update_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.kmeans_update_smem_bytes.restype = ctypes.c_size_t
    _LIB["lib"] = lib
  return _LIB["lib"]


# (N, K, dsub) -> True once B0's block takes it
_FITS = {}


def kmeans_update(x: torch.Tensor, w: torch.Tensor, assign: torch.Tensor,
                  centroids: torch.Tensor) -> torch.Tensor:
  """B0 wrapper: plain version on CPU tensors, the CUDA kernel on CUDA
  tensors (or an error).  Counts its kernel launches in `.launches`."""
  if x.dim() != 3 or centroids.dim() != 3:
    raise ValueError(f"B0 takes x (R, N, dsub) and centroids (R, K, dsub), "
                     f"got {tuple(x.shape)} and {tuple(centroids.shape)}")
  r, n, dsub = x.shape
  k = centroids.shape[1]
  if centroids.shape[0] != r or centroids.shape[2] != dsub or k == 0:
    raise ValueError(f"centroids shape {tuple(centroids.shape)} does not "
                     f"match x {tuple(x.shape)}")
  if tuple(w.shape) != (r, n) or tuple(assign.shape) != (r, n):
    raise ValueError(f"w {tuple(w.shape)} and assign {tuple(assign.shape)} "
                     f"must be ({r}, {n})")
  if x.device.type == "cpu":
    return kmeans_update_plain(x, w, assign, centroids)
  if any(t.device != x.device for t in (w, assign, centroids)):
    raise ValueError("B0 inputs must be on one device")
  _build.require_sm90(x.device)
  if x.dtype not in _DTYPE_CODES:
    raise TypeError(f"x must be bf16 or f32, got {x.dtype}")
  if (w.dtype, assign.dtype, centroids.dtype) != (
      torch.float32, torch.int32, torch.float32):
    raise TypeError(f"B0 takes w f32, assign int32 and centroids f32, got "
                    f"{w.dtype}, {assign.dtype}, {centroids.dtype}")
  if dsub not in _DSUBS:
    raise ValueError(f"B0 takes dsub in {_DSUBS}, got {dsub}")
  if not all(t.is_contiguous() for t in (x, w, assign, centroids)):
    raise ValueError("B0 inputs must be contiguous")
  lib = _lib()
  if (n, k, dsub) not in _FITS:
    smem = lib.kmeans_update_smem_bytes(n, k, dsub)
    if smem > SMEM_LIMIT:
      raise ValueError(f"B0 needs {smem} B of shared memory for K={k}, "
                       f"dsub={dsub}; a block has {SMEM_LIMIT}")
    _FITS[(n, k, dsub)] = True
  out = torch.empty((r, k, dsub), dtype=torch.float32, device=x.device)
  err = lib.kmeans_update_launch(
      _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), assign.data_ptr(),
      centroids.data_ptr(), out.data_ptr(), r, n, k, dsub,
      torch.cuda.current_stream(x.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"kmeans_update kernel launch failed: CUDA error {err}")
  kmeans_update.launches += 1
  return out


kmeans_update.launches = 0
