"""whisper-large-v3 [audio]: enc-dec, 32L enc + 32L dec, d_model=1280, 20H
(GQA kv=20 == MHA), d_ff=5120, vocab=51866.  Conv audio frontend is a STUB —
inputs are precomputed frame embeddings (B, 1500, d_model).
[arXiv:2212.04356; unverified]
"""
from repro_torch.config import AttentionConfig, ModelConfig, register_arch

NAME = "whisper-large-v3"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="encdec",
        num_layers=32,
        num_encoder_layers=32,
        encoder_seq_len=1500,
        d_model=1280,
        d_ff=5120,
        vocab_size=51_866,
        mlp="gelu",
        norm="layernorm",
        attention=AttentionConfig(
            kind="gqa", num_heads=20, num_kv_heads=20, head_dim=64, rope=False
        ),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke",
        family="encdec",
        num_layers=2,
        num_encoder_layers=2,
        encoder_seq_len=16,
        d_model=64,
        d_ff=128,
        vocab_size=512,
        mlp="gelu",
        norm="layernorm",
        attention=AttentionConfig(
            kind="gqa", num_heads=4, num_kv_heads=4, head_dim=16, rope=False
        ),
    )


register_arch(NAME, full, smoke)
