"""internvl2-26b [vlm]: InternLM2-20B backbone, 48L, d_model=6144, 48H
(GQA kv=8), d_ff=16384, vocab=92553.  InternViT frontend is a STUB: 1024
precomputed patch embeddings (dim 3200) are projected and replace the first
1024 token positions.  [arXiv:2404.16821; hf]
"""
from repro_torch.config import AttentionConfig, ModelConfig, register_arch

NAME = "internvl2-26b"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="decoder",
        num_layers=48,
        d_model=6144,
        d_ff=16_384,
        vocab_size=92_553,
        mlp="swiglu",
        num_patch_tokens=1024,
        frontend_dim=3200,
        attention=AttentionConfig(kind="gqa", num_heads=48, num_kv_heads=8, head_dim=128),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke",
        family="decoder",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=512,
        mlp="swiglu",
        num_patch_tokens=8,
        frontend_dim=32,
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16),
    )


register_arch(NAME, full, smoke)
