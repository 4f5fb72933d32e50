"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests see the real (1) device;
only launch/dryrun.py pins 512 placeholder devices, in its own process."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # benchmarks/

import jax
import numpy as np
import pytest


@pytest.fixture
def rng():
  return np.random.default_rng(0)


@pytest.fixture
def key():
  return jax.random.PRNGKey(0)


def pytest_configure(config):
  config.addinivalue_line(
      "markers", "cuda: needs a CUDA card (sm_90a); skipped without one")
