"""jamba-v0.1-52b [hybrid]: 32L, d_model=4096, 32H (GQA kv=8), d_ff=14336,
vocab=65536, MoE 16 experts top-2 — Mamba+attention 1:7 interleave (one
attention layer per period of 8, index 3), MoE every other layer.
[arXiv:2403.19887; hf]
"""
from repro_torch.config import AttentionConfig, ModelConfig, MoEConfig, SSMConfig, register_arch

NAME = "jamba-v0.1-52b"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="hybrid",
        num_layers=32,
        d_model=4096,
        d_ff=14_336,
        vocab_size=65_536,
        mlp="swiglu",
        hybrid_attn_period=8,
        hybrid_attn_index=3,
        moe_every_k=2,
        moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=14_336, group_size=2048),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        attention=AttentionConfig(kind="gqa", num_heads=32, num_kv_heads=8, head_dim=128),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke",
        family="hybrid",
        num_layers=8,
        d_model=64,
        d_ff=128,
        vocab_size=512,
        mlp="swiglu",
        hybrid_attn_period=8,
        hybrid_attn_index=3,
        moe_every_k=2,
        moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=128),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16),
    )


register_arch(NAME, full, smoke)
