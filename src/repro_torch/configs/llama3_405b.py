"""llama3-405b [dense] — GQA, 128k vocab; the capacity-wall flagship.
[arXiv:2407.21783; unverified]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab_size=128256,
    fsdp=True,   # 810 GB bf16 params: must shard over BOTH mesh axes
    microbatches=8,  # bound live activations: 1M-token global batch in chunks
    source="arXiv:2407.21783", verified="unverified",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, pq_m=4, pq_k=16, pq_sink=4, pq_recent=8,
    attn_block=64, dtype_str="float32")
