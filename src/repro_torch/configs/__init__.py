"""Architecture configs of the port; importing registers them."""
from repro_torch.configs import (  # noqa: F401
    granite_3_8b,
    granite_8b,
    granite_moe_3b_a800m,
    jamba_v0_1_52b,
    minicpm3_4b,
    nemotron_4_340b,
    qwen2_moe_a2_7b,
    resnet18_imagenet,
    rwkv6_7b,
)
