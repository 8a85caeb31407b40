"""minicpm3-4b [dense]: 62L, d_model=2560, 40H (GQA kv=40), d_ff=6400,
vocab=73448 — MLA (multi-head latent attention).
[hf:openbmb/MiniCPM3-4B; hf]
"""
from repro_torch.config import AttentionConfig, ModelConfig, register_arch

NAME = "minicpm3-4b"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="decoder",
        num_layers=62,
        d_model=2560,
        d_ff=6400,
        vocab_size=73_448,
        mlp="swiglu",
        attention=AttentionConfig(
            kind="mla",
            num_heads=40,
            num_kv_heads=40,
            q_lora_rank=768,
            kv_lora_rank=256,
            qk_nope_head_dim=64,
            qk_rope_head_dim=32,
            v_head_dim=64,
        ),
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
        attention=AttentionConfig(
            kind="mla",
            num_heads=4,
            num_kv_heads=4,
            q_lora_rank=32,
            kv_lora_rank=16,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        ),
    )


register_arch(NAME, full, smoke)
