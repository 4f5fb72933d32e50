"""rwkv6-3b [ssm] — Finch, data-dependent decay; attention-free.
[arXiv:2404.05892; hf]  AQPIM inapplicable (no KV cache) — DESIGN.md §5."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536,
    attn_free=True, pq_enabled=False,
    microbatches=4,
    source="arXiv:2404.05892", verified="hf",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab_size=256, attn_block=64, dtype_str="float32")
