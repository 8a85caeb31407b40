"""nemotron-4-340b [dense]: 96L, d_model=18432, 96H (GQA kv=8), d_ff=73728,
vocab=256000 — squared-ReLU MLP, LayerNorm.  [arXiv:2402.16819; unverified]

At 340B parameters (1.36 TB in fp32) the full config does not fit one
H100's 80 GB; the port runs it at smoke size.  Its head dim, 192, is one
the flash kernels take.
"""
from repro_torch.config import AttentionConfig, ModelConfig, register_arch

NAME = "nemotron-4-340b"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="decoder",
        num_layers=96,
        d_model=18_432,
        d_ff=73_728,
        vocab_size=256_000,
        mlp="relu2",
        norm="layernorm",
        attention=AttentionConfig(kind="gqa", num_heads=96, num_kv_heads=8, head_dim=192),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke",
        family="decoder",
        num_layers=2,
        d_model=96,
        d_ff=384,
        vocab_size=512,
        mlp="relu2",
        norm="layernorm",
        attention=AttentionConfig(kind="gqa", num_heads=6, num_kv_heads=2, head_dim=16),
    )


register_arch(NAME, full, smoke)
