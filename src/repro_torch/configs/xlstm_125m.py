"""xlstm-125m [ssm]: sLSTM + mLSTM blocks (arXiv:2405.04517).

12 layers as 3 groups of (3 mLSTM + 1 sLSTM).  d_ff=0 per spec: blocks
carry internal up/down projections.  Sub-quadratic: long_500k runs
(O(1) recurrent state decode).
"""
from repro_torch.models.config import ArchConfig, XLSTMCfg

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv=4, d_head=192,
    d_ff=0, vocab=50304, act="gelu",
    xlstm=XLSTMCfg(m_per_group=3, s_per_group=1, expand_m=2, qk_frac=0.5),
    subquadratic=True,
)

SMOKE = ArchConfig(
    name="xlstm-125m-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=4, n_kv=4, d_head=16,
    d_ff=0, vocab=512, act="gelu",
    xlstm=XLSTMCfg(m_per_group=3, s_per_group=1, expand_m=2, qk_frac=0.5),
    subquadratic=True, remat="none",
)
