"""granite-3-8b [dense]: 40L, d_model=4096, 32H (GQA kv=8), d_ff=12800,
vocab=49155.  [hf:ibm-granite/granite-3.0-2b-base; hf]
"""
from repro_torch.config import AttentionConfig, ModelConfig, register_arch

NAME = "granite-3-8b"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="decoder",
        num_layers=40,
        d_model=4096,
        d_ff=12_800,
        vocab_size=49_155,
        mlp="swiglu",
        attention=AttentionConfig(kind="gqa", num_heads=32, num_kv_heads=8, head_dim=128),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke",
        family="decoder",
        num_layers=2,
        d_model=64,
        d_ff=160,
        vocab_size=512,
        mlp="swiglu",
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16),
    )


register_arch(NAME, full, smoke)
