"""Helpers shared by the port's parity tests (`test_torch_*.py`)."""
import dataclasses

import jax
import numpy as np

from repro.configs import get_arch as j_get_arch
from repro.launch.engine import ServeEngine as JEngine
from repro_torch.configs import get_arch as t_get_arch
from repro_torch.launch.engine import ServeEngine as TEngine


def assert_pq_indices_match(ref_idx, got_idx, ref_codebooks, body_len):
  """PQ indices of the port equal the reference's on every valid body row.

  ref_idx/got_idx (B, H, N, m); ref_codebooks (B, H, m, K, dsub) f32;
  body_len (B,) valid body rows per request.  Where the reference's codebook
  holds bit-identical copies of the chosen centroid (masked rows collapse
  onto row 0 at the k-means init), which copy wins is an exact tie: there
  the decoded centroid must be equal instead.  Rows at or past body_len are
  padding that decode masks and overwrites, and are not compared.
  """
  ref = np.asarray(ref_idx).astype(np.int64)
  got = np.asarray(got_idx).astype(np.int64)
  cb = np.asarray(ref_codebooks, np.float32)
  for b in range(ref.shape[0]):
    r, g = ref[b, :, :body_len[b]], got[b, :, :body_len[b]]
    h_i, n_i, m_i = np.meshgrid(*map(np.arange, r.shape), indexing="ij")
    chosen = cb[b, h_i, m_i, r]                           # (H, n, m, dsub)
    np.testing.assert_array_equal(cb[b, h_i, m_i, g], chosen)
    copies = (cb[b][h_i, m_i] == chosen[..., None, :]).all(-1).sum(-1)
    np.testing.assert_array_equal(g[copies == 1], r[copies == 1])


ARCH = "tinyllama-1.1b"
CONTEXT, PROMPT_CAP, MAX_BATCH = 112, 64, 3


def engine_pair(policy, layout, sched, num_blocks=None, j_kernel="xla",
                **cfg_kw):
  """Reference and port engines over the same weights; `cfg_kw` are further
  config fields, set on both."""
  kw = dict(cache_policy=policy, dtype_str="float32", cache_layout=layout,
            scheduler=sched, **cfg_kw)
  jcfg = dataclasses.replace(j_get_arch(ARCH, reduced=True),
                             decode_kernel=j_kernel, **kw)
  tcfg = dataclasses.replace(t_get_arch(ARCH, reduced=True),
                             decode_kernel="torch", **kw)
  je = JEngine(jcfg, context_len=CONTEXT, max_batch=MAX_BATCH,
               prompt_capacity=PROMPT_CAP, num_blocks=num_blocks)
  params = jax.tree_util.tree_map(np.asarray, je.params)
  te = TEngine(tcfg, context_len=CONTEXT, max_batch=MAX_BATCH,
               prompt_capacity=PROMPT_CAP, params=params, device="cpu",
               num_blocks=num_blocks)
  return je, te


def random_trace(seed, n=6):
  rng = np.random.default_rng(seed)
  return [(rng.integers(0, 256, size=int(rng.integers(40, PROMPT_CAP + 1))),
           int(rng.integers(2, 12))) for _ in range(n)]
