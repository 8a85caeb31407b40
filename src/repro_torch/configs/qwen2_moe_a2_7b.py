"""qwen2-moe-a2.7b [moe]: 24L, d_model=2048, 16H (GQA kv=16), expert
d_ff=1408, vocab=151936 — 4 shared + 60 routed experts, top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.config import AttentionConfig, ModelConfig, MoEConfig, register_arch

NAME = "qwen2-moe-a2.7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="decoder",
        num_layers=24,
        d_model=2048,
        d_ff=1408,
        vocab_size=151_936,
        mlp="swiglu",
        moe=MoEConfig(
            num_experts=60,
            top_k=4,
            expert_d_ff=1408,
            num_shared_experts=4,
            shared_d_ff=5632,
            group_size=1024,
            pad_experts_to=64,
        ),
        attention=AttentionConfig(kind="gqa", num_heads=16, num_kv_heads=16, head_dim=128),
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
        moe=MoEConfig(
            num_experts=6, top_k=2, expert_d_ff=64, num_shared_experts=2, shared_d_ff=128
        ),
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=4, head_dim=16),
    )


register_arch(NAME, full, smoke)
