"""rwkv6-7b [ssm]: 32L, d_model=4096 (attention-free), d_ff=14336,
vocab=65536 — "Finch", data-dependent decay.  [arXiv:2404.05892; hf]
"""
from repro_torch.config import ModelConfig, RWKVConfig, register_arch

NAME = "rwkv6-7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=NAME,
        family="rwkv",
        num_layers=32,
        d_model=4096,
        d_ff=14_336,
        vocab_size=65_536,
        rwkv=RWKVConfig(head_dim=64, decay_lora=64),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=NAME + "-smoke",
        family="rwkv",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=512,
        rwkv=RWKVConfig(head_dim=16, decay_lora=8),
    )


register_arch(NAME, full, smoke)
