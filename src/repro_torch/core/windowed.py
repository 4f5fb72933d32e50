"""Page-aware windowed clustering (AQPIM §III-B Fig. 6 + §III-F co-design).

Port of `repro.core.windowed`: the body divides into `n_windows` codebook
pages; each later window warm-starts from the previous window's centroids.
`n_windows == 1` (one page for the whole context) is the paper's default and
the only geometry the decode kernel serves; the warm-start loop stays for
multi-window configs.  Leading batch dimensions replace `vmap`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import pq


def windowed_build_codebooks(
    x: torch.Tensor,
    weights: torch.Tensor,
    cfg: pq.PQConfig,
    n_windows: int,
    mask: Optional[torch.Tensor] = None,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Cluster (..., N, d) tokens into n_windows warm-started codebook pages
  (every k-means assignment through K6 and every update through B0 with
  `use_kernel`).

  Returns codebooks (..., n_windows, m, K, dsub) f32 and indices (..., N, m)
  int32.
  """
  *lead, n, d = x.shape
  if n % n_windows:
    raise ValueError(f"N={n} must divide into n_windows={n_windows}")
  w_len = n // n_windows
  if mask is None:
    mask = torch.ones(weights.shape, dtype=torch.bool, device=x.device)
  mask = mask.expand(weights.shape)
  xs = x.reshape(*lead, n_windows, w_len, d)
  ws = weights.reshape(*lead, n_windows, w_len)
  ms = mask.reshape(*lead, n_windows, w_len)

  cb, idx = pq.build_codebook(xs[..., 0, :, :], ws[..., 0, :], cfg,
                              mask=ms[..., 0, :], use_kernel=use_kernel)
  cbs, idxs = [cb], [idx]
  for i in range(1, n_windows):
    cb, idx = pq.build_codebook(xs[..., i, :, :], ws[..., i, :], cfg,
                                mask=ms[..., i, :], init_codebook=cb,
                                use_kernel=use_kernel)
    cbs.append(cb)
    idxs.append(idx)
  return torch.stack(cbs, dim=-4), torch.cat(idxs, dim=-2)


def windowed_encode(x: torch.Tensor, codebooks: torch.Tensor,
                    window_ids: torch.Tensor) -> torch.Tensor:
  """Encode tokens against their window's codebook page.

  x (..., d); codebooks (..., nW, m, K, dsub); window_ids (...) -> (..., m)
  int32.  The distance is the direct sum of squares, as in the reference
  (and as its single-page decode-time encode).  Used at decode to append an
  evicted token's indices (paper Fig. 3a decode step 3).
  """
  *lead, n_w, m, k, dsub = codebooks.shape
  sel = window_ids.long().reshape(*lead, 1, 1, 1, 1).expand(*lead, 1, m, k,
                                                             dsub)
  cb = torch.gather(codebooks, -4, sel).squeeze(-4).float()   # (..., m, K, dsub)
  xs = x.float().reshape(*x.shape[:-1], m, 1, dsub)
  d2 = torch.sum((cb - xs) ** 2, dim=-1)                     # (..., m, K)
  return torch.argmin(d2, dim=-1).to(torch.int32)
