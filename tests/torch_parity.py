"""Helpers shared by the port's parity tests (`test_torch_*.py`)."""
import numpy as np


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
