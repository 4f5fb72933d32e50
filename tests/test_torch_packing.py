"""The port's sub-byte KV packing against the reference's, on the CPU.

Inputs come from numpy seeds and go through `repro.kernels.packing` and
`repro_torch.kernels.packing`:

  - codes and the f16 scale/min headers bit-equal for bits 4, 5 and 8, over
    many seeds, widths and magnitudes, including ROADMAP C4's example
    (seed 9643, bits 8, d 8, magnitude 1e-3), whose f16 scales are
    subnormal: the port reproduces the reference's quantization there, it
    does not repair it;
  - `dequant_page` bit-equal (its plain widen and the K8 wrapper, which
    takes the plain widen on CPU tensors);
  - K8's wrapper equal to `unpack_u4_kernel(interpret=True)`.

The CUDA leg of K8 (the kernel against `unpack_u4` on the card) is in
`test_torch_cuda_kernels.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import packing as j_pk
from repro_torch.kernels import packing as t_pk

F16_MIN_NORMAL = 2.0 ** -14


def _bits_of(x) -> np.ndarray:
  """Raw bits of an f16/f32/uint8 array, so equality is bitwise."""
  x = np.asarray(x)
  return x.view({2: np.uint16, 4: np.uint32}.get(x.dtype.itemsize, x.dtype))


def _assert_quantized_equal(x: np.ndarray, bits: int) -> None:
  d = x.shape[-1]
  group = j_pk.group_size(d)
  assert t_pk.group_size(d) == group
  ref = j_pk.quantize_rows(jnp.asarray(x), bits=bits, group=group)
  got = t_pk.quantize_rows(torch.from_numpy(x), bits=bits, group=group)
  for r, g in zip(ref, got):
    assert str(g.dtype) == f"torch.{np.asarray(r).dtype}"
    np.testing.assert_array_equal(_bits_of(g.numpy()), _bits_of(r))
  ref = j_pk.pack_rows(jnp.asarray(x), bits=bits, group=group)
  got = t_pk.pack_rows(torch.from_numpy(x), bits=bits, group=group)
  assert got[0].shape[-1] == t_pk.packed_width(d, bits)
  for r, g in zip(ref, got):
    np.testing.assert_array_equal(_bits_of(g.numpy()), _bits_of(r))


@pytest.mark.parametrize("bits", [4, 5, 8])
@pytest.mark.parametrize("d", [8, 24, 64, 128])
def test_pack_rows_bit_equal_to_reference(bits, d):
  """Rows of 80 seeds, each at its own magnitude, in one call per width
  (the functions are row-wise)."""
  rows = []
  for seed in range(80):
    rng = np.random.default_rng(seed)
    mag = float(rng.choice([1e-4, 1e-3, 1e-2, 1.0, 3.0, 1e3]))
    x = rng.normal(scale=mag, size=(3, d))
    x[0, :d // 2] = x[0, 0]              # a constant group: f16 scale 0
    rows.append(x)
  _assert_quantized_equal(np.concatenate(rows).astype(np.float32), bits)


def test_subnormal_scales_match_reference_c4():
  """ROADMAP C4's example (seed 9643, bits 8, d 8, magnitude 1e-3), drawn
  as the reference's property test draws it: its f16 scales are subnormal
  and both sides round them alike."""
  rng = np.random.default_rng(9643)
  x = rng.normal(scale=1e-3, size=(3, 8)).astype(np.float32)
  _, scale, _ = t_pk.quantize_rows(torch.from_numpy(x), bits=8,
                                   group=t_pk.group_size(8))
  assert (scale.float().abs() < F16_MIN_NORMAL).all()
  _assert_quantized_equal(x, 8)


@pytest.mark.parametrize("bits", [4, 5, 8])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_dequant_page_bit_equal_to_reference(bits, use_kernel):
  rng = np.random.default_rng(bits)
  d = 64
  group = t_pk.group_size(d)
  x = rng.normal(scale=2.0, size=(3, 2, 5, d)).astype(np.float32)
  pack, scale, mn = j_pk.pack_rows(jnp.asarray(x), bits=bits, group=group)
  ref = j_pk.dequant_page(pack, scale, mn, bits=bits, group=group)
  before = t_pk.unpack_u4_kernel.launches
  got = t_pk.dequant_page(
      torch.from_numpy(np.asarray(pack)), torch.from_numpy(np.asarray(scale)),
      torch.from_numpy(np.asarray(mn)), bits=bits, group=group,
      use_kernel=use_kernel)
  assert t_pk.unpack_u4_kernel.launches == before    # CPU: no launch
  assert got.dtype == torch.float32
  np.testing.assert_array_equal(_bits_of(got.numpy()), _bits_of(ref))


@pytest.mark.parametrize("n,dp", [(7, 8), (64, 32), (33, 4)])
def test_unpack_u4_kernel_matches_interpret_kernel(n, dp):
  rng = np.random.default_rng(n * dp)
  p = rng.integers(0, 256, size=(n, dp)).astype(np.uint8)
  ref = j_pk.unpack_u4_kernel(jnp.asarray(p), interpret=True)
  got = t_pk.unpack_u4_kernel(torch.from_numpy(p))
  assert got.dtype == torch.int32 and tuple(got.shape) == (n, 2 * dp)
  np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
  np.testing.assert_array_equal(t_pk.unpack_u4(torch.from_numpy(p)).numpy(),
                                np.asarray(j_pk.unpack_u4(jnp.asarray(p))))


@pytest.mark.parametrize("d", [8, 16, 64, 128])
def test_pack_unpack_u5_match_reference(d):
  rng = np.random.default_rng(d)
  q = rng.integers(0, 32, size=(6, d)).astype(np.uint8)
  ref = np.asarray(j_pk.pack_u5(jnp.asarray(q)))
  got = t_pk.pack_u5(torch.from_numpy(q))
  np.testing.assert_array_equal(got.numpy(), ref)
  np.testing.assert_array_equal(t_pk.unpack_u5(got).numpy(),
                                q.astype(np.int32))
  np.testing.assert_array_equal(
      t_pk.pack_u4(torch.from_numpy(q & 0xF)).numpy(),
      np.asarray(j_pk.pack_u4(jnp.asarray(q & 0xF))))


def test_codec_registry_and_widths_match_reference():
  assert t_pk.RESIDENT_CODECS == j_pk.RESIDENT_CODECS
  for d in (8, 24, 64, 128):
    for bits in (4, 5, 8):
      assert t_pk.packed_width(d, bits) == j_pk.packed_width(d, bits)


def test_unpack_u4_kernel_refuses_bad_inputs():
  with pytest.raises(ValueError, match="(n, dp)"):
    t_pk.unpack_u4_kernel(torch.zeros(2, 3, 4, dtype=torch.uint8))
  with pytest.raises(TypeError, match="uint8"):
    t_pk.unpack_u4_kernel(torch.zeros(2, 4, dtype=torch.int32))
