"""Architecture configs of the port; importing registers them.

The 10 assigned architectures + the paper's own ResNet-18/ImageNet, as the
reference's ``repro/configs``.  ``repro_torch.config.get_arch(name)`` /
``get_arch(name, smoke=True)``.
"""
from repro_torch.configs import (  # noqa: F401
    granite_3_8b,
    granite_8b,
    granite_moe_3b_a800m,
    internvl2_26b,
    jamba_v0_1_52b,
    minicpm3_4b,
    nemotron_4_340b,
    qwen2_moe_a2_7b,
    resnet18_imagenet,
    rwkv6_7b,
    whisper_large_v3,
)

ASSIGNED = [
    "whisper-large-v3",
    "minicpm3-4b",
    "granite-3-8b",
    "granite-8b",
    "nemotron-4-340b",
    "internvl2-26b",
    "granite-moe-3b-a800m",
    "qwen2-moe-a2.7b",
    "jamba-v0.1-52b",
    "rwkv6-7b",
]
