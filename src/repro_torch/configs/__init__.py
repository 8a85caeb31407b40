"""Architecture configs of the port; importing registers them."""
from repro_torch.configs import granite_8b, resnet18_imagenet, rwkv6_7b  # noqa: F401
