"""seamless-m4t-large-v2 [audio]: enc-dec, multimodal (arXiv:2308.11596).

Interpreted as 24 encoder + 24 decoder layers (speech encoder + text
decoder of the real model).  The audio frontend is a stub: input_specs()
provides precomputed frame embeddings for the encoder.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=48, enc_layers=24, dec_layers=24,
    d_model=1024, n_heads=16, n_kv=16, d_head=64,
    d_ff=8192, vocab=256206, act="gelu",
    frontend="audio",
    microbatch=2,
)

SMOKE = ArchConfig(
    name="seamless-m4t-large-v2-smoke", family="audio",
    n_layers=4, enc_layers=2, dec_layers=2,
    d_model=64, n_heads=4, n_kv=4, d_head=16,
    d_ff=160, vocab=512, act="gelu", frontend="audio", remat="none",
)
