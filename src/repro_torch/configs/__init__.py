"""Architecture configs of the port; importing registers them."""
from repro_torch.configs import (  # noqa: F401
    granite_3_8b,
    granite_8b,
    nemotron_4_340b,
    resnet18_imagenet,
    rwkv6_7b,
)
