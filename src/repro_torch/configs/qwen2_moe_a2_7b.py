"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4 experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936,
    n_experts=60, top_k=4, moe_d_ff=1408, n_shared_experts=4,
    microbatches=4,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B", verified="hf",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    d_ff=96, moe_d_ff=96, n_experts=8, top_k=2, n_shared_experts=1,
    vocab_size=256, pq_m=8, pq_k=16, pq_sink=4, pq_recent=8,
    attn_block=64, dtype_str="float32")
