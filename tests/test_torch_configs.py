"""The port's configs equal the reference's, field for field."""
import dataclasses

import pytest
import torch

from repro.configs import registry as jreg
from repro_torch.configs import registry as treg

_ARCHS = sorted(jreg._MODULES)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", _ARCHS)
def test_config_fields_equal_reference(arch, reduced):
  j = jreg.get_arch(arch, reduced=reduced)
  t = treg.get_arch(arch, reduced=reduced)
  jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
  tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
  assert tf == jf
  want = {"bfloat16": torch.bfloat16, "float32": torch.float32}[j.dtype_str]
  assert t.dtype == want


def _pq_fields(c):
  return (c.sink, c.recent, c.body_capacity, c.n_windows, c.pq.m, c.pq.k,
          c.pq.iters)


@pytest.mark.parametrize("context", [40, 56, 100, 1040, 4095, 4096, 33000])
@pytest.mark.parametrize("arch,reduced", [
    ("tinyllama-1.1b", False), ("tinyllama-1.1b", True),
    ("llama3-405b", False), ("musicgen-medium", True)])
def test_pq_cache_config_equal_reference(arch, reduced, context):
  j = jreg.get_arch(arch, reduced=reduced)
  t = treg.get_arch(arch, reduced=reduced)
  assert _pq_fields(t.pq_cache_config(context)) == \
      _pq_fields(j.pq_cache_config(context))


def test_pq_cache_config_none_unless_pq():
  t = dataclasses.replace(treg.get_arch("tinyllama-1.1b"),
                          cache_policy="exact")
  assert t.pq_cache_config(1040) is None
  assert treg.get_arch("rwkv6-3b").pq_cache_config(1040) is None


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "rwkv6-3b", "hymba-1.5b",
                                  "llama-3.2-vision-11b", "musicgen-medium"])
def test_unported_family_raises_naming_roadmap(arch):
  with pytest.raises(NotImplementedError, match="ROADMAP A14"):
    treg.require_served(treg.get_arch(arch, reduced=True))
