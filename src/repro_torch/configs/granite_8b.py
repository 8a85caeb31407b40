"""granite-8b [dense]: 36L, d_model=4096, 32H (GQA kv=8), d_ff=14336,
vocab=49152 — llama-arch, code.  [arXiv:2405.04324; hf]
"""
from repro_torch.config import AttentionConfig, ModelConfig, register_arch

NAME = "granite-8b"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="decoder",
        num_layers=36,
        d_model=4096,
        d_ff=14_336,
        vocab_size=49_152,
        mlp="swiglu",
        attention=AttentionConfig(kind="gqa", num_heads=32, num_kv_heads=8, head_dim=128),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke",
        family="decoder",
        num_layers=3,
        d_model=64,
        d_ff=192,
        vocab_size=512,
        mlp="swiglu",
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16),
    )


register_arch(NAME, full, smoke)
