"""nemotron-4-15b [dense]: GQA + squared-ReLU MLP (arXiv:2402.16819)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv=8, d_head=128,
    d_ff=24576, vocab=256000, act="sq_relu",
    microbatch=4,
)

SMOKE = ArchConfig(
    name="nemotron-4-15b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv=2, d_head=8,
    d_ff=160, vocab=512, act="sq_relu", remat="none",
)
