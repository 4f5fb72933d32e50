"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2, GQA kv=8.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab_size=32064,
    n_experts=16, top_k=2, moe_d_ff=6400, n_shared_experts=0,
    microbatches=4, fsdp=True,
    source="hf:microsoft/Phi-3.5-MoE-instruct", verified="hf",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, moe_d_ff=96, n_experts=4, top_k=2,
    vocab_size=256, pq_m=4, pq_k=16, pq_sink=4, pq_recent=8,
    attn_block=64, dtype_str="float32")
