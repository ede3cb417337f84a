"""dbrx-132b [moe]: 16 experts top-4, fine-grained (hf:databricks/dbrx)."""
from repro_torch.models.config import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv=8, d_head=128,
    d_ff=10752, vocab=100352, act="swiglu",
    moe=MoECfg(n_experts=16, top_k=4, d_ff_expert=10752),
    microbatch=16, remat="full", param_dtype="bfloat16",
)

SMOKE = ArchConfig(
    name="dbrx-132b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=8, n_kv=2, d_head=8,
    d_ff=96, vocab=512, act="swiglu",
    moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=96), remat="none",
)
