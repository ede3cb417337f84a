"""qwen3-14b [dense]: qk_norm, GQA (hf:Qwen/Qwen3-8B family scaling)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv=8, d_head=128,
    d_ff=17408, vocab=151936, act="swiglu", qk_norm=True,
    microbatch=4,
)

SMOKE = ArchConfig(
    name="qwen3-14b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv=2, d_head=8,
    d_ff=160, vocab=512, act="swiglu", qk_norm=True, remat="none",
)
