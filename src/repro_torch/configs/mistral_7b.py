"""mistral-7b [dense] — the paper's own evaluation model (§IV-A).
[arXiv:2310.06825; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000, rope_theta=1000000.0,
    source="arXiv:2310.06825", verified="hf",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, pq_m=4, pq_k=16, pq_sink=4, pq_recent=8,
    attn_block=64, dtype_str="float32")
