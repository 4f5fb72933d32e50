"""musicgen-medium [audio] — decoder-only over EnCodec tokens; MHA kv=24.
Frontend (EnCodec) is a STUB: input_specs provides precomputed frame embeddings.
[arXiv:2306.05284; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    frontend="audio_frames",
    microbatches=4,
    source="arXiv:2306.05284", verified="hf",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab_size=64, pq_m=8, pq_k=16, pq_sink=4, pq_recent=8,
    attn_block=64, dtype_str="float32")
