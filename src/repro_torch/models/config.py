"""Architecture configuration dataclasses (one instance per assigned arch),
the port's own copy of the reference's, field for field: plain Python,
shared by both packages' configs only by value."""
from __future__ import annotations

import dataclasses
from typing import Literal

Act = Literal["swiglu", "sq_relu", "gelu"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int           # routed experts (padded for sharding if needed)
    top_k: int
    d_ff_expert: int
    n_shared: int = 0        # always-on shared experts (merged into one)
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    padded_experts: int | None = None  # for sharding (>= n_experts)

    @property
    def e_pad(self) -> int:
        return self.padded_experts or self.n_experts


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    state: int = 64          # N
    heads: int = 32
    expand: int = 2          # d_inner = expand * d_model
    conv_kernel: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    m_per_group: int = 3     # mLSTM layers per group
    s_per_group: int = 1     # sLSTM layers per group
    expand_m: int = 2
    qk_frac: float = 0.5     # qk head dim as fraction of v head dim
    expand_s_ffn: float = 1.3333


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    act: Act = "swiglu"
    qk_norm: bool = False
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # family extensions
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    xlstm: XLSTMCfg | None = None
    # hybrid (zamba2): shared attn+mlp block applied every `shared_every`
    shared_every: int = 0
    # enc-dec (seamless)
    enc_layers: int = 0
    dec_layers: int = 0
    # modality frontend stub: 'none' | 'vision' | 'audio'
    frontend: str = "none"
    n_prefix: int = 0        # prefix embeddings from the frontend stub
    # numerics / memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "dots"      # 'none' | 'dots' | 'full'
    loss_chunk: int = 512    # chunked cross-entropy block
    attn_impl: str = "auto"  # 'auto'|'xla'|'chunked'|'banded'|'flash'
    attn_chunk: int = 512
    # MoE dispatch collective policy: 'dense' (XLA default: all-reduce of
    # the scattered output) | 'sharded' (constrain expert/tokens layouts so
    # GSPMD emits reduce-scatter; the dbrx hillclimb, EXPERIMENTS.md §Perf)
    moe_dispatch: str = "dense"
    # sequence-parallel attention: shard the q-chunk rows of the attention
    # logits over 'model' so the (B,H,c,S) softmax tensor is 16x smaller
    # per device (heads often don't divide the model axis; the q-seq dim
    # always does).  Off = paper-faithful baseline; the qwen3/phi3
    # hillclimb (EXPERIMENTS.md §Perf)
    attn_sp: bool = False
    attn_bands: int = 8      # for 'banded' inductive attention
    # training-shape policy
    microbatch: int = 1      # gradient-accumulation steps
    # long-context capability (sub-quadratic path exists)
    subquadratic: bool = False

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def param_count(self) -> int:
        """Rough analytical parameter count (sanity checks / roofline N)."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        att = d * (self.n_heads + 2 * self.n_kv) * self.d_head \
            + self.n_heads * self.d_head * d
        if self.act == "swiglu":
            ffn = 3 * d * self.d_ff
        else:
            ffn = 2 * d * self.d_ff
        if self.family == "moe" and self.moe:
            ffn = 3 * d * self.moe.d_ff_expert * self.moe.n_experts
            if self.moe.n_shared:
                ffn += 3 * d * self.moe.d_ff_shared
            ffn += d * self.moe.n_experts  # router
        if self.family == "hybrid" and self.ssm:
            di = self.ssm.expand * d
            n = self.ssm.state
            mamba = d * (2 * di + 2 * n + self.ssm.heads) + di * d \
                + self.ssm.conv_kernel * (di + 2 * n)
            shared = att + 3 * d * self.d_ff
            return total + self.n_layers * mamba \
                + (shared if self.shared_every else 0)
        if self.family == "ssm" and self.xlstm:
            di = self.xlstm.expand_m * d
            dqk = int(di * self.xlstm.qk_frac)
            m = d * (2 * dqk + 2 * di) + di * d + 3 * self.n_heads * di
            s = 4 * d * d + d * d + 2 * int(
                d * self.xlstm.expand_s_ffn) * d
            g = self.xlstm.m_per_group + self.xlstm.s_per_group
            groups = self.n_layers // g
            return total + groups * (self.xlstm.m_per_group * m
                                     + self.xlstm.s_per_group * s)
        layers = self.enc_layers + self.dec_layers if self.is_encdec \
            else self.n_layers
        cross = att if self.is_encdec else 0
        return total + layers * (att + ffn) + self.dec_layers * cross

    def active_param_count(self) -> int:
        """Activated params per token (MoE-aware) for MODEL_FLOPS=6*N*D."""
        if self.family == "moe" and self.moe:
            d = self.d_model
            att = d * (self.n_heads + 2 * self.n_kv) * self.d_head \
                + self.n_heads * self.d_head * d
            ffn = 3 * d * self.moe.d_ff_expert * self.moe.top_k
            if self.moe.n_shared:
                ffn += 3 * d * self.moe.d_ff_shared
            return self.vocab * d * 2 + self.n_layers * (att + ffn)
        return self.param_count()
