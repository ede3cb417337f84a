"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention block
(arXiv:2411.15242).  54 mamba layers, a single shared attn+MLP block
applied every 9 layers (6 applications).  Sub-quadratic: long_500k runs.
"""
from repro_torch.models.config import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv=32, d_head=80,
    d_ff=10240, vocab=32000, act="swiglu",
    ssm=SSMCfg(state=64, heads=32, expand=2, conv_kernel=4, chunk=128),
    shared_every=9, subquadratic=True,
    microbatch=2,
)

SMOKE = ArchConfig(
    name="zamba2-2.7b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv=4, d_head=16,
    d_ff=160, vocab=512, act="swiglu",
    ssm=SSMCfg(state=8, heads=4, expand=2, conv_kernel=4, chunk=16),
    shared_every=2, subquadratic=True, remat="none",
)
