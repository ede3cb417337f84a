"""internvl2-76b [vlm]: InternViT + InternLM2 backbone (arXiv:2404.16821).

Backbone only; the vision frontend is a stub — input_specs() supplies
precomputed patch embeddings (n_prefix tokens) prepended to the text.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_head=128,
    d_ff=28672, vocab=128256, act="swiglu",
    frontend="vision", n_prefix=256,
    microbatch=16, remat="full", param_dtype="bfloat16",
)

SMOKE = ArchConfig(
    name="internvl2-76b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=8, n_kv=2, d_head=8,
    d_ff=160, vocab=512, act="swiglu",
    frontend="vision", n_prefix=8, remat="none",
)
