"""granite-moe-3b-a800m [moe]: 32L, d_model=1536, 24H (GQA kv=8),
expert d_ff=512, vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.config import AttentionConfig, ModelConfig, MoEConfig, register_arch

NAME = "granite-moe-3b-a800m"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="decoder",
        num_layers=32,
        d_model=1536,
        d_ff=512,
        vocab_size=49_155,
        mlp="swiglu",
        moe=MoEConfig(num_experts=40, top_k=8, expert_d_ff=512, group_size=128,
                      pad_experts_to=48),
        attention=AttentionConfig(kind="gqa", num_heads=24, num_kv_heads=8, head_dim=64),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke",
        family="decoder",
        num_layers=2,
        d_model=64,
        d_ff=64,
        vocab_size=512,
        mlp="swiglu",
        moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=64),
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16),
    )


register_arch(NAME, full, smoke)
