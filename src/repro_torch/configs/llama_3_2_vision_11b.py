"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th layer.
Vision tower is a STUB: input_specs provides precomputed patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    cross_attn_period=5, n_modal_tokens=1600, frontend="vision_patches",
    microbatches=4,
    source="hf:meta-llama/Llama-3.2-11B-Vision", verified="unverified",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, cross_attn_period=2, n_modal_tokens=16,
    pq_m=4, pq_k=16, pq_sink=4, pq_recent=8, attn_block=64,
    dtype_str="float32")
