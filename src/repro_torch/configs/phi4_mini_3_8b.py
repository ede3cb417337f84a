"""phi4-mini-3.8b [dense]: RoPE SwiGLU GQA (arXiv:2412.08905)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv=8, d_head=128,
    d_ff=8192, vocab=200064, act="swiglu",
    microbatch=2,
)

SMOKE = ArchConfig(
    name="phi4-mini-3.8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv=2, d_head=8,
    d_ff=160, vocab=512, act="swiglu", remat="none",
)
