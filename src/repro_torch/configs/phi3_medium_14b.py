"""phi3-medium-14b [dense]: RoPE SwiGLU GQA (arXiv:2404.14219)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv=10, d_head=128,
    d_ff=17920, vocab=100352, act="swiglu",
    microbatch=4,
)

SMOKE = ArchConfig(
    name="phi3-medium-14b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv=2, d_head=8,
    d_ff=160, vocab=512, act="swiglu", remat="none",
)
