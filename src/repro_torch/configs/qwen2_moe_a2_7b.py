"""qwen2-moe-a2.7b [moe]: 60 routed experts top-4 + shared expert
(hf:Qwen/Qwen1.5-MoE-A2.7B).  Experts padded 60 -> 64 for even EP
sharding over the 16-way model axis (padding experts masked in routing).
"""
from repro_torch.models.config import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv=16, d_head=128,
    d_ff=1408, vocab=151936, act="swiglu",
    moe=MoECfg(n_experts=60, top_k=4, d_ff_expert=1408,
               n_shared=4, d_ff_shared=5632, padded_experts=64),
    microbatch=2,
)

SMOKE = ArchConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_head=16,
    d_ff=96, vocab=512, act="swiglu",
    moe=MoECfg(n_experts=6, top_k=2, d_ff_expert=96,
               n_shared=1, d_ff_shared=128, padded_experts=8),
    remat="none",
)
