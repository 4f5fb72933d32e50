"""hymba-1.5b [hybrid] — parallel attention + mamba heads, ssm_state=16.
PQ applies to the attention heads' KV; SSM heads carry recurrent state.
[arXiv:2411.13676; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    hybrid=True, ssm_state=16, ssm_d_inner=1600,
    microbatches=4,
    source="arXiv:2411.13676", verified="hf",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, ssm_d_inner=64, pq_m=4, pq_k=16,
    pq_sink=4, pq_recent=8, attn_block=64, dtype_str="float32")
