"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked `cuda`: without a card every test skips.  This file imports no JAX,
so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_kernels.py

Tolerance 1e-4: f32 accumulation in another order over the same bf16 (or
f32) inputs.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_flash_decode as t_pfd
from repro_torch.kernels import pq_decode as t_pqd

CUDA_ATOL = 1e-4


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (sm_90a); runs on the chip")
  return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [
    (4, 2, 16, 4, 16, 64, torch.uint8),       # reduced: m=4, K=16, dsub=4
    (16, 8, 64, 32, 512, 1024, torch.int16),  # full tinyllama: dsub=2
    (16, 8, 64, 32, 512, 1024, torch.int32),
])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_cuda_pq_decode_matches_plain(cuda_device, geometry, q_dtype):
  bh, g, d, m, k, n, idx_dtype = geometry
  dev = cuda_device
  gen = torch.Generator(device=dev).manual_seed(5)
  q = torch.randn(bh, g, d, generator=gen, device=dev).to(q_dtype)
  kcb, vcb = (torch.randn(bh, m, k, d // m, generator=gen, device=dev
                          ).to(torch.bfloat16) for _ in range(2))
  kidx, vidx = (torch.randint(0, k, (bh, n, m), generator=gen, device=dev
                              ).to(idx_dtype) for _ in range(2))
  ln = torch.randint(0, n + 1, (bh,), generator=gen, device=dev,
                     dtype=torch.int32)
  ln[0], ln[-1] = 0, n
  before = t_pqd.pq_decode_attention.launches
  out, stats = t_pqd.pq_decode_attention(q, kcb, vcb, kidx, vidx, ln,
                                         d ** -0.5)
  plain = t_pqd.pq_decode_attention_plain(q, kcb, vcb, kidx, vidx, ln,
                                          d ** -0.5)
  torch.cuda.synchronize()
  assert t_pqd.pq_decode_attention.launches == before + 1
  torch.testing.assert_close(out, plain[0], atol=CUDA_ATOL, rtol=CUDA_ATOL)
  torch.testing.assert_close(stats, plain[1], atol=CUDA_ATOL, rtol=CUDA_ATOL)
  assert torch.all(out[0] == 0) and torch.all(stats[0, 1] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d", [(8, 64), (2, 16)])
def test_cuda_flash_decode_matches_plain(cuda_device, dtype, g, d):
  dev = cuda_device
  gen = torch.Generator(device=dev).manual_seed(6)
  bh, n = 16, 1040
  q = torch.randn(bh, g, d, generator=gen, device=dev).to(dtype)
  k, v = (torch.randn(bh, n, d, generator=gen, device=dev).to(dtype)
          for _ in range(2))
  ln = torch.randint(0, n + 1, (bh,), generator=gen, device=dev,
                     dtype=torch.int32)
  ln[0], ln[-1] = 0, n
  before = t_pfd.flash_decode.launches
  out = t_pfd.flash_decode(q, k, v, ln, d ** -0.5)
  plain = t_pfd.flash_decode_plain(q, k, v, ln, d ** -0.5)
  torch.cuda.synchronize()
  assert t_pfd.flash_decode.launches == before + 1
  torch.testing.assert_close(out, plain, atol=CUDA_ATOL, rtol=CUDA_ATOL)
  assert torch.all(out[0] == 0)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_inputs(cuda_device):
  dev = cuda_device
  q = torch.zeros(2, 2, 16, device=dev)
  cb = torch.zeros(2, 4, 16, 4, device=dev)         # f32: the kernel reads bf16
  idx = torch.zeros(2, 8, 4, dtype=torch.int32, device=dev)
  ln = torch.zeros(2, dtype=torch.int32, device=dev)
  with pytest.raises(TypeError, match="bf16"):
    t_pqd.pq_decode_attention(q, cb, cb, idx, idx, ln, 0.25)
  with pytest.raises(TypeError, match="share"):
    t_pfd.flash_decode(q, torch.zeros(2, 8, 16, dtype=torch.bfloat16,
                                      device=dev),
                       torch.zeros(2, 8, 16, dtype=torch.bfloat16, device=dev),
                       ln, 0.25)
