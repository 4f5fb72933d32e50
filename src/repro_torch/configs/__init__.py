"""Architecture configs (one module per arch) + registry."""
from repro_torch.configs.registry import ARCHS, get_arch

__all__ = ["ARCHS", "get_arch"]
