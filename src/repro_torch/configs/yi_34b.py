"""yi-34b [dense] — llama-arch GQA. [arXiv:2403.04652; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    microbatches=4, fsdp=True,
    source="arXiv:2403.04652", verified="hf",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, pq_m=4, pq_k=16, pq_sink=4, pq_recent=8,
    attn_block=64, dtype_str="float32")
