"""granite-3-8b [dense] — GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab_size=49155,
    microbatches=4,
    source="hf:ibm-granite/granite-3.0-2b-base", verified="hf",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, pq_m=4, pq_k=16, pq_sink=4, pq_recent=8,
    attn_block=64, dtype_str="float32")
